"""Move parameter and state trees between numpy and the port.

The trees are nested dicts of numpy arrays in the JAX package's layout:
parameters `time/{w,b}`, `msg/{w1,b1,w2,b2}`, `mem/{w,u,b}`,
`emb/l<i>/{wq,wk,wv,wo}` (JODIE: `emb/l0/{w_proj,w_out}`, `emb/l<i>/w`),
`dec/{w1,b1,w2,b2}`, `node_cls/...`, `pres/gamma_logit` (weights (in,
out), used as `x @ W`, never transposed); state `memory/{mem,last_update}`,
`neighbors/{nbr,t,ptr}`, `pres/{n,xi,psi}` (a row per node, or per hash
bucket with `pres_buckets`; the port adds its dump row after either) and,
for APAN, `mailbox/{msg,t,ptr}`; the pipelined
schedule's snapshot `{read_mem, read_last_update, pending, tick}`; and
the model zoo's parameter trees (`embed/table`, `final_norm/scale`,
`blocks/u{i}/b{j}/...` or, stacked, `blocks/b{j}/...` with a leading
unit dim; the MoE family's `dense_{i}/...` and `blocks/.../moe/{router,
wi, wg, wo}` with (E, d, f) expert leaves; whisper's `dec_pos`,
`enc_final_norm` and `enc` / `dec` stacks), and back to numpy the port's
zoo gradients and optimizer states in the same layout. Converting from JAX arrays to numpy is the caller's business; nothing here
sees a JAX array.

`mdgnn_bundle` / `mdgnn_bundle_from_numpy` carry the {"params", "state"}
bundle that the train CLI checkpoints: the state's `memory` and `pres`
are `MemoryState` / `PresState` nodes, as the JAX state holds its
dataclasses, so the bundle flattens and renders as JAX's does
(`checkpoint/io.py`)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pres import PresState
from repro_torch.device import resolve_device
from repro_torch.models.modules import MemoryState


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _is_bf16(a) -> bool:
    """A bf16 numpy array: JAX's `ml_dtypes.bfloat16`, or the raw `|V2`
    bf16 values a checkpoint holds."""
    dt = np.asarray(a).dtype
    return dt.name == "bfloat16" or dt == np.dtype("V2")


def _memory_rows(a, device):
    """The memory table: bf16 where the array is bf16 (carried as fp32,
    exact, then rounded back, which changes no value), else fp32."""
    if not _is_bf16(a):
        return _tensor(a, torch.float32, device)
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        from repro_torch.checkpoint.io import bf16_bits_to_tensor
        return bf16_bits_to_tensor(a).to(device)
    return _tensor(a.astype(np.float32), torch.float32,
                   device).to(torch.bfloat16)


def _with_dump(a, fill):
    """Append the port's trailing dump row to a node-indexed array."""
    a = np.asarray(a)
    return np.concatenate([a, np.full((1,) + a.shape[1:], fill, a.dtype)])


def params_from_numpy(tree, device=None) -> dict:
    """Float32 tensors on `device` with the tree's names and shapes."""
    dev = resolve_device(device)
    return {k: params_from_numpy(v, dev) if isinstance(v, dict)
            else _tensor(v, torch.float32, dev) for k, v in tree.items()}


def state_from_numpy(tree, device=None) -> dict:
    """The port's runtime state from the JAX state layout (adds the dump
    rows of the rings and trackers). A bf16 memory table stays bf16."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    mem, nb, pr = tree["memory"], tree["neighbors"], tree["pres"]
    state = {
        "memory": MemoryState(mem=_memory_rows(mem["mem"], dev),
                              last_update=_tensor(mem["last_update"], f32,
                                                  dev)),
        "neighbors": {"nbr": _tensor(_with_dump(nb["nbr"], -1), i32, dev),
                      "t": _tensor(_with_dump(nb["t"], 0), f32, dev),
                      "ptr": _tensor(_with_dump(nb["ptr"], 0), i32, dev)},
        "pres": PresState(n=_tensor(_with_dump(pr["n"], 0), f32, dev),
                          xi=_tensor(_with_dump(pr["xi"], 0), f32, dev),
                          psi=_tensor(_with_dump(pr["psi"], 0), f32, dev)),
    }
    if "mailbox" in tree:
        mb = tree["mailbox"]
        state["mailbox"] = {
            "msg": _tensor(_with_dump(mb["msg"], 0), f32, dev),
            "t": _tensor(_with_dump(mb["t"], 0), f32, dev),
            "ptr": _tensor(_with_dump(mb["ptr"], 0), i32, dev)}
    return state


def state_to_numpy(state) -> dict:
    """The JAX state layout as numpy arrays (dump rows dropped; a bf16
    memory table as float32, exact)."""
    mem, nb, pr = state["memory"], state["neighbors"], state["pres"].rows()
    out = {
        "memory": {"mem": _np(mem.mem), "last_update": _np(mem.last_update)},
        "neighbors": {k: _np(nb[k][:-1]) for k in ("nbr", "t", "ptr")},
        "pres": {"n": _np(pr.n), "xi": _np(pr.xi), "psi": _np(pr.psi)},
    }
    if "mailbox" in state:
        out["mailbox"] = {k: _np(v[:-1]) for k, v in state["mailbox"].items()}
    return out


def _np(t):
    """numpy of a tensor; a bf16 one as float32 (exact: numpy has no
    bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def pipeline_state_from_numpy(tree, device=None):
    """The pipelined schedule's `PipelineState` from the JAX layout
    (`pending` gets the port's dump row, `tick` becomes a host int)."""
    from repro_torch.train.pipeline import PipelineState
    dev = resolve_device(device)
    f32 = torch.float32
    return PipelineState(
        read_mem=_tensor(tree["read_mem"], f32, dev),
        read_last_update=_tensor(tree["read_last_update"], f32, dev),
        pending=_tensor(_with_dump(tree["pending"], 0), f32, dev),
        tick=int(tree["tick"]))


def pipeline_state_to_numpy(pstate) -> dict:
    """The JAX `PipelineState` layout as numpy (the dump row dropped)."""
    return {"read_mem": _np(pstate.read_mem),
            "read_last_update": _np(pstate.read_last_update),
            "pending": _np(pstate.pending[:-1]), "tick": pstate.tick}


# a model zoo parameter tree (unstacked `blocks/u{i}/...` or stacked
# `blocks/...` alike) is float32 (`param_dtype`), as the MDGNN's is
zoo_params_from_numpy = params_from_numpy


def zoo_params_to_numpy(params) -> dict:
    """A zoo tree of tensors (parameters, gradients, an optimizer state
    with its int32 step) as numpy arrays, in its own layout."""
    return {k: zoo_params_to_numpy(v) if isinstance(v, dict) else _np(v)
            for k, v in params.items()}


def mdgnn_bundle(params, state) -> dict:
    """The {"params", "state"} checkpoint bundle in the JAX layout, as
    views of the port's tensors: dump rows dropped, the memory and the
    trackers as `MemoryState` and `PresState` nodes."""
    mem, nb = state["memory"], state["neighbors"]
    st = {"memory": MemoryState(mem=mem.mem, last_update=mem.last_update),
          "neighbors": {k: nb[k][:-1] for k in ("nbr", "t", "ptr")},
          "pres": state["pres"].rows()}
    if "mailbox" in state:
        st["mailbox"] = {k: v[:-1] for k, v in state["mailbox"].items()}
    return {"params": params, "state": st}


def mdgnn_bundle_from_numpy(bundle, device=None):
    """(params, state) on `device` from a bundle of `mdgnn_bundle`'s
    layout holding numpy arrays (the dump rows added back)."""
    st = dict(bundle["state"])
    mem, pr = st["memory"], st["pres"]
    st["memory"] = {"mem": mem.mem, "last_update": mem.last_update}
    st["pres"] = {"n": pr.n, "xi": pr.xi, "psi": pr.psi}
    return (params_from_numpy(bundle["params"], device),
            state_from_numpy(st, device))
