"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
