"""MDGNN building blocks (counterpart of `repro/models/modules.py`): the
memory table, the cosine time encoding, the MESSAGE MLP and the GRU cell.
Weights keep the JAX layout: `x @ W` with W of shape (in, out)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MemoryState:
    """The memory table S and its last-write times. The serving path
    updates both IN PLACE (the JAX engine donates them)."""
    mem: torch.Tensor          # (N, D) float32
    last_update: torch.Tensor  # (N,) float32

    @staticmethod
    def init(n_nodes: int, d_mem: int, device) -> "MemoryState":
        return MemoryState(
            mem=torch.zeros((n_nodes, d_mem), dtype=torch.float32,
                            device=device),
            last_update=torch.zeros((n_nodes,), dtype=torch.float32,
                                    device=device))


def time_encode(params, dt):
    """dt: (...,) -> (..., d_time) = cos(dt * w + b).

    The angle is rounded to float32 once, as the fused multiply-add that
    jitted XLA and nvcc emit for dt * w + b (the float64 product is exact).
    With dt * w near 1e4 a second rounding alone moves the cosine by ~1e-3."""
    ang = dt.double()[..., None] * params["w"].double() + params["b"].double()
    return torch.cos(ang.float())


def message(params, s_self, s_other, e_feat, t_enc):
    """MESSAGE MLP over [s_self, s_other, e_feat, phi(dt)]."""
    x = torch.cat([s_self, s_other, e_feat, t_enc], dim=-1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def gru_cell(params, x, h):
    """x: (B, d_in), h: (B, d_hidden) -> new h. The plain cell: the serving
    path runs it inside the memory_update_table kernel, whose plain version
    (kernels/ref.py) calls this."""
    gx = x @ params["w"] + params["b"]
    gh = h @ params["u"]
    d = h.shape[-1]
    rx, zx, nx = gx[..., :d], gx[..., d:2 * d], gx[..., 2 * d:]
    rh, zh, nh = gh[..., :d], gh[..., d:2 * d], gh[..., 2 * d:]
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1 - z) * h + z * n
