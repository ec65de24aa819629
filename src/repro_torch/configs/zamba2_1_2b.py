"""zamba2-1.2b [hybrid] — Mamba2 backbone + single shared attention block
applied every 6th layer [arXiv:2411.15242]."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_head_dim=64, mamba_expand=2, attn_every=6,
    tie_embeddings=True,
)
