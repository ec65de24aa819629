"""The paper's own model, TGN trained with PRES (counterpart of
`repro/configs/tgn_pres.py`, same values).

`CONFIG` is the synthetic-benchmark scale. `PRODUCTION` is the node and
feature scale of the JAX package's distributed dry-run; it streams its
events from an on-disk store (`event_store`, graph/store.py; written by
`python -m repro_torch.launch.convert_events --synthetic stream-10m`).
`chip_smoke.py` runs it over a cut of that store (train-production-store)
and its widths on a smaller in-RAM graph."""
from repro_torch.models.mdgnn import MDGNNConfig

CONFIG = MDGNNConfig(
    variant="tgn",
    n_nodes=1000,
    d_edge=16,
    d_mem=100, d_msg=100, d_time=32, d_embed=100,
    n_neighbors=10,
    n_layers=1,          # the paper's ablation default (1-hop attention)
    use_pres=True,
    beta=0.1,            # the paper's beta
)

PRODUCTION = MDGNNConfig(
    variant="tgn",
    n_nodes=1_048_576,   # a 1M-node graph
    d_edge=172,          # wiki/reddit edge-feature width
    d_mem=128, d_msg=128, d_time=64, d_embed=128,
    n_neighbors=16,
    n_layers=2,          # 2-hop attention: the TGL/DistTGL production depth
    use_pres=True,
    beta=0.1,
    event_store="stores/stream-10m",
)
