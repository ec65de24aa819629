"""Architecture configs (counterpart of `repro/configs/__init__.py`).

`get_config(arch_id)` returns the config of an architecture: one of the
model zoo's ten (`ARCH_IDS`, as in JAX) or "tgn-pres", the paper model's
`tgn_pres.CONFIG` (an `MDGNNConfig`). `SHAPES` are the dry run's input
shapes (`launch/dryrun.py`, `launch/specs.py::make_spec`), with JAX's
values."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_MODULES = {
    "arctic-480b": "arctic_480b",
    "xlstm-350m": "xlstm_350m",
    "gemma3-12b": "gemma3_12b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-7b": "qwen2_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-1.2b": "zamba2_1_2b",
    "tgn-pres": "tgn_pres",
}

ARCH_IDS = [a for a in ARCH_MODULES if a != "tgn-pres"]


def get_config(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{list(ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention or a bounded state
LONG_500K_OK = {"xlstm-350m", "zamba2-1.2b", "gemma3-12b"}


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_500K_OK
    return True
