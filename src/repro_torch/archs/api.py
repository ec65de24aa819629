"""Model construction: `get_model(cfg)` dispatches on the family
(counterpart of `repro/archs/api.py`). Families not ported yet raise
NotImplementedError naming the ROADMAP item that ports them."""
from __future__ import annotations

from repro_torch.archs import dense, xlstm_arch, zamba
from repro_torch.archs.base import Model, ModelConfig

_BUILDERS = {
    "dense": dense.build,
    "vlm": dense.build,
    "ssm": xlstm_arch.build,
    "hybrid": zamba.build,
}

NOT_PORTED = {
    "moe": "Queue 1 item 19 (zoo: MoE, nn/moe.py, archs/moe_arch.py)",
    "audio": "Queue 1 item 19 (zoo: whisper, cross_attention, layernorm)",
}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.arch_id}) is not ported yet; "
            f"ROADMAP {NOT_PORTED[cfg.family]}")
    try:
        builder = _BUILDERS[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for "
                         f"{cfg.arch_id}") from None
    return builder(cfg)
