"""Model construction: `get_model(cfg)` dispatches on the family
(counterpart of `repro/archs/api.py`)."""
from __future__ import annotations

from repro_torch.archs import dense, moe_arch, whisper, xlstm_arch, zamba
from repro_torch.archs.base import Model, ModelConfig

_BUILDERS = {
    "dense": dense.build,
    "vlm": dense.build,
    "moe": moe_arch.build,
    "ssm": xlstm_arch.build,
    "hybrid": zamba.build,
    "audio": whisper.build,
}


def get_model(cfg: ModelConfig) -> Model:
    try:
        builder = _BUILDERS[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for "
                         f"{cfg.arch_id}") from None
    return builder(cfg)
