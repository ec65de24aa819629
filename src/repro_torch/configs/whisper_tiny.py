"""whisper-tiny [audio] — enc-dec, conv frontend stubbed to precomputed
frame embeddings [arXiv:2212.04356]. 4 encoder + 4 decoder layers; the
decoder position table is extended to max_seq for the decode shapes."""
from repro_torch.archs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny", family="audio",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
    d_ff=1536, vocab=51865,
    enc_frames=1500, act="gelu", tie_embeddings=True,
    max_seq=32768,
)
