"""Move parameter and state trees between numpy and the port.

The trees are nested dicts of numpy arrays in the JAX package's layout:
parameters `time/{w,b}`, `msg/{w1,b1,w2,b2}`, `mem/{w,u,b}`,
`emb/l<i>/{wq,wk,wv,wo}`, `dec/{w1,b1,w2,b2}`, `node_cls/...`,
`pres/gamma_logit` (weights (in, out), used as `x @ W`, never transposed);
state `memory/{mem,last_update}`, `neighbors/{nbr,t,ptr}`,
`pres/{n,xi,psi}`. Converting from JAX arrays to numpy is the caller's
business; nothing here sees a JAX array."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pres import PresState
from repro_torch.device import resolve_device
from repro_torch.models.modules import MemoryState


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


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
    rows of the rings and trackers)."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    mem, nb, pr = tree["memory"], tree["neighbors"], tree["pres"]
    return {
        "memory": MemoryState(mem=_tensor(mem["mem"], f32, dev),
                              last_update=_tensor(mem["last_update"], f32,
                                                  dev)),
        "neighbors": {"nbr": _tensor(_with_dump(nb["nbr"], -1), i32, dev),
                      "t": _tensor(_with_dump(nb["t"], 0), f32, dev),
                      "ptr": _tensor(_with_dump(nb["ptr"], 0), i32, dev)},
        "pres": PresState(n=_tensor(_with_dump(pr["n"], 0), f32, dev),
                          xi=_tensor(_with_dump(pr["xi"], 0), f32, dev),
                          psi=_tensor(_with_dump(pr["psi"], 0), f32, dev)),
    }


def state_to_numpy(state) -> dict:
    """The JAX state layout as numpy arrays (dump rows dropped)."""
    np_ = lambda t: t.detach().cpu().numpy()
    mem, nb, pr = state["memory"], state["neighbors"], state["pres"].rows()
    return {
        "memory": {"mem": np_(mem.mem), "last_update": np_(mem.last_update)},
        "neighbors": {k: np_(nb[k][:-1]) for k in ("nbr", "t", "ptr")},
        "pres": {"n": np_(pr.n), "xi": np_(pr.xi), "psi": np_(pr.psi)},
    }
