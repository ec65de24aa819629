"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (vision encoder stubbed to
precomputed patch embeddings) [arXiv:2409.12191]."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936,
    qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w bands over head_dim/2 = 64
    num_patches=256,
    tie_embeddings=True,
)
