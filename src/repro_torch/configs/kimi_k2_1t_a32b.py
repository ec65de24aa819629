"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8, first
layer dense, one shared expert [arXiv:2501.kimi2]. GQA with kv=8 (not
MLA), as the JAX package's table specifies."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, first_dense=1, n_shared_experts=1,
    rope_theta=50_000.0, tie_embeddings=False,
)
