"""qwen2-7b [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab=152064,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
)
