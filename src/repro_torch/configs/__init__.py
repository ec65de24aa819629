"""Architecture configs (counterpart of
`repro/configs/__init__.py`), cut down to the ported architectures.

`get_config(arch_id)` returns the config of a ported architecture; any
other architecture the JAX package configures raises NotImplementedError
naming the ROADMAP item that ports it."""
from __future__ import annotations

import importlib

ARCH_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "qwen3-0.6b": "qwen3_0_6b",
}

# the JAX package's other architectures -> the ROADMAP item that ports them
NOT_PORTED = {
    "arctic-480b": "Queue 1 item 19 (zoo: MoE, nn/moe.py, archs/moe_arch.py)",
    "kimi-k2-1t-a32b": "Queue 1 item 19 (zoo: MoE, nn/moe.py, "
                       "archs/moe_arch.py)",
    "gemma3-12b": "Queue 1 item 19 (zoo: dense configs beyond qwen3-0.6b)",
    "command-r-plus-104b": "Queue 1 item 19 (zoo: dense configs beyond "
                           "qwen3-0.6b)",
    "qwen2-7b": "Queue 1 item 19 (zoo: dense configs beyond qwen3-0.6b)",
    "qwen2-vl-2b": "Queue 1 item 19 (zoo: VLM, apply_mrope)",
    "whisper-tiny": "Queue 1 item 19 (zoo: whisper, cross_attention, "
                    "layernorm)",
    "zamba2-1.2b": "Queue 1 item 19 (zoo: zamba2, mamba2, archs/zamba.py)",
    "tgn-pres": "the MDGNN path (repro_torch.models.mdgnn.MDGNNConfig)",
}

ARCH_IDS = list(ARCH_MODULES)


def get_config(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet; ROADMAP {NOT_PORTED[arch_id]}")
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
    return mod.CONFIG
