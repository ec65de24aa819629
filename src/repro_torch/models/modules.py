"""MDGNN building blocks (counterpart of `repro/models/modules.py`): the
memory table, the cosine time encoding, the MESSAGE MLP and the memory
cells (GRU and the vanilla RNN). Weights keep the JAX layout: `x @ W` with
W of shape (in, out)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MemoryState:
    """The memory table S and its last-write times. The serving path
    updates both IN PLACE (the JAX engine donates them)."""
    mem: torch.Tensor          # (N, D) float32 or bfloat16
    last_update: torch.Tensor  # (N,) float32

    @staticmethod
    def init(n_nodes: int, d_mem: int, device,
             dtype=torch.float32) -> "MemoryState":
        return MemoryState(
            mem=torch.zeros((n_nodes, d_mem), dtype=dtype, device=device),
            last_update=torch.zeros((n_nodes,), dtype=torch.float32,
                                    device=device))


# logical sharding axes of the state (nn/module.py's rules resolve them)
MEMORY_STATE_AXES = MemoryState(mem=("nodes", "embed"),
                                last_update=("nodes",))


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
    """x: (B, d_in), h: (B, d_hidden) -> new h. The plain cell: it is the
    plain version of the gru_cell kernel and, inside memory_update_table's,
    of the fused PRES pass (kernels/ref.py)."""
    gx = x @ params["w"] + params["b"]
    gh = h @ params["u"]
    d = h.shape[-1]
    rx, zx, nx = gx[..., :d], gx[..., d:2 * d], gx[..., 2 * d:]
    rh, zh, nh = gh[..., :d], gh[..., d:2 * d], gh[..., 2 * d:]
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    return (1 - z) * h + z * n


def gru_shapes(d_in: int, d_hidden: int) -> dict:
    return {"w": (d_in, 3 * d_hidden), "u": (d_hidden, 3 * d_hidden),
            "b": (3 * d_hidden,)}


def rnn_shapes(d_in: int, d_hidden: int) -> dict:
    return {"w": (d_in, d_hidden), "u": (d_hidden, d_hidden),
            "b": (d_hidden,)}


def rnn_cell(params, x, h):
    """The vanilla RNN memory cell tanh(x W + h U + b). The JAX package has
    no kernel for it, so its products are plain matrix products."""
    return torch.tanh(x @ params["w"] + h @ params["u"] + params["b"])


# cfg.memory_cell -> its parameter shapes of (d_in, d_hidden); the cell
# itself is picked by mdgnn.memory_cell (the GRU runs as a kernel)
MEMORY_CELL_SHAPES = {"gru": gru_shapes, "rnn": rnn_shapes}
