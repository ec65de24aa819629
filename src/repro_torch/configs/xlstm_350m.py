"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517]."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,  # pattern unit: 7 mLSTM + 1 sLSTM
    tie_embeddings=True,
)
