"""gemma3-12b [dense] — 5:1 local(1024-window):global attention, 128k ctx
[hf:google/gemma-3-1b-pt]."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=15360, vocab=262144,
    window=1024, global_every=6, rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=True,
)
