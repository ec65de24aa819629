"""xLSTM blocks (arXiv:2405.04517; counterpart of `repro/nn/xlstm.py`):
mLSTM (matrix memory, chunk-parallel through `ssm.chunked_linear_rnn` and
its `ssd_chunk` kernel) and sLSTM (scalar memory, a loop over time).

mLSTM's state C_t (Dk x Dv) with
    C_t = f_t C_{t-1} + i_t k_t v_t^T,   n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t^T C_t) / max(|q_t^T n_t|, 1)
carries the normaliser n by augmenting v with a column of ones; sigmoid
forget and exp-free input gates (the stabilised variant), as in JAX."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import rmsnorm, rmsnorm_init
from repro_torch.nn.module import ParamBuilder
from repro_torch.nn.ssm import chunked_linear_rnn, linear_rnn_step
from repro_torch.train import annotate


def _floor1(x):
    """max(x, 1) with jnp.maximum's gradient (half to each side on a tie;
    torch.clamp passes all of it, ROADMAP Queue 3 P7)."""
    return torch.maximum(x, torch.ones_like(x))


def _logsigmoid(x):
    """F.logsigmoid, on local tensors where x is a DTensor (DTensor has no
    rule for its backward)."""
    return annotate.local(F.logsigmoid, x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(b: ParamBuilder, name: str, d_model: int, n_heads: int):
    d_head = d_model // n_heads
    sub = b.sub(name)
    sub.add("wq", (d_model, n_heads * d_head), ("embed", "heads"))
    sub.add("wk", (d_model, n_heads * d_head), ("embed", "heads"))
    sub.add("wv", (d_model, n_heads * d_head), ("embed", "heads"))
    sub.add("wif", (d_model, 2 * n_heads), ("embed", None))
    sub.add("bif", (2 * n_heads,), (None,), init="zeros")
    sub.add("wo", (n_heads * d_head, d_model), ("heads", "embed"))
    rmsnorm_init(sub, "out_norm", d_model)


def _mlstm_qkv(params, x, n_heads):
    dt = x.dtype
    b_, s, _ = x.shape

    def heads(y):
        return y.reshape(b_, s, n_heads, -1)
    q = heads(x @ params["wq"].to(dt))
    k = heads(x @ params["wk"].to(dt))
    v = heads(x @ params["wv"].to(dt))
    gates = x @ params["wif"].to(dt) + params["bif"].to(dt)
    i_g, f_g = torch.chunk(gates.float(), 2, dim=-1)          # (B, S, H)
    log_f = _logsigmoid(f_g)
    i_g = torch.exp(_logsigmoid(i_g))      # stabilised input gate in (0, 1)
    k = k / math.sqrt(q.shape[-1])
    return q, k, v, i_g, log_f


def mlstm(params, x, *, n_heads: int, chunk: int = 256, init_state=None,
          return_state: bool = False, mode: str | None = None):
    b_, s, _ = x.shape
    q, k, v, i_g, log_f = _mlstm_qkv(params, x, n_heads)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    k_in = k * i_g[..., None]
    y_aug, state = chunked_linear_rnn(q, k_in, v_aug, log_f, chunk=chunk,
                                      init_state=init_state, mode=mode)
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    h = y / _floor1(torch.abs(n))
    out = h.reshape(b_, s, -1).to(x.dtype) @ params["wo"].to(x.dtype)
    out = rmsnorm(params["out_norm"], out)
    if return_state:
        return out, state
    return out


# the logical axes of the decode states, as JAX's xlstm_arch.state_axes
# gives them: the mLSTM matrix state sharded on batch only (4 heads do not
# divide the model axis); the sLSTM (h, c, n) triple one axes entry
# (("batch", "embed"),) * 3, which resolves to a replicated spec
MLSTM_STATE_AXES = ("batch", None, None, None)
SLSTM_STATE_AXES = (("batch", "embed"),) * 3


def mlstm_decode_init(batch: int, d_model: int, n_heads: int, device=None):
    d_head = d_model // n_heads
    return torch.zeros((batch, n_heads, d_head, d_head + 1),
                       dtype=torch.float32, device=device)


def mlstm_decode(params, x, state, *, n_heads: int):
    """x: (B, 1, d). Returns (out, state)."""
    q, k, v, i_g, log_f = _mlstm_qkv(params, x, n_heads)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    state, y_aug = linear_rnn_step(state, q[:, 0],
                                   (k * i_g[..., None])[:, 0],
                                   v_aug[:, 0], log_f[:, 0])
    y, n = y_aug[..., :-1], y_aug[..., -1:]
    h = (y / _floor1(torch.abs(n)))[:, None]
    b_ = x.shape[0]
    out = h.reshape(b_, 1, -1).to(x.dtype) @ params["wo"].to(x.dtype)
    return rmsnorm(params["out_norm"], out), state


# ---------------------------------------------------------------------------
# sLSTM — scalar memory, sequential over time
# ---------------------------------------------------------------------------


def slstm_init(b: ParamBuilder, name: str, d_model: int, n_heads: int):
    sub = b.sub(name)
    # input and recurrent weights of the 4 gates (i, f, z, o)
    sub.add("w", (d_model, 4 * d_model), ("embed", "mlp"))
    sub.add("r", (n_heads, d_model // n_heads, 4 * (d_model // n_heads)),
            (None, None, None))
    sub.add("bias", (4 * d_model,), ("mlp",), init="zeros")
    rmsnorm_init(sub, "out_norm", d_model)


def _slstm_cell(params, x_t, carry, n_heads):
    """x_t: (B, 4d) pre-projected inputs; carry: (h, c, n), each (B, d)
    float32."""
    h, c, n = carry
    b_, d4 = x_t.shape
    d = d4 // 4
    dh = d // n_heads
    hh = h.reshape(b_, n_heads, dh)
    rec = torch.einsum("bhk,hkg->bhg", hh, params["r"].float())
    # (B, H, 4 dh) -> (B, 4, H, dh) -> (B, 4d): the gate-major layout of the
    # input projection and the bias
    rec = rec.reshape(b_, n_heads, 4, dh).transpose(1, 2).reshape(b_, 4 * d)
    pre = x_t.float() + rec + params["bias"].float()
    i_g, f_g, z_g, o_g = torch.chunk(pre, 4, dim=-1)
    i_g = torch.exp(_logsigmoid(i_g))                      # stabilised
    f_g = torch.sigmoid(f_g)
    z_g = torch.tanh(z_g)
    o_g = torch.sigmoid(o_g)
    c = f_g * c + i_g * z_g
    n = f_g * n + i_g
    h_new = o_g * c / _floor1(n)
    return (h_new, c, n)


def slstm(params, x, *, n_heads: int, init_state=None,
          return_state: bool = False):
    """x: (B, S, d). A loop over time (JAX's lax.scan)."""
    b_, s, d = x.shape
    xw = x @ params["w"].to(x.dtype)                        # (B, S, 4d)
    if init_state is None:
        zero = torch.zeros((b_, d), dtype=torch.float32, device=x.device)
        init_state = (zero, zero, zero)
    carry = init_state
    hs = []
    for t in range(s):
        carry = _slstm_cell(params, xw[:, t], carry, n_heads)
        hs.append(carry[0])
    out = rmsnorm(params["out_norm"], torch.stack(hs, dim=1).to(x.dtype))
    if return_state:
        return out, carry
    return out


def slstm_decode_init(batch: int, d_model: int, device=None):
    zero = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return (zero, zero, zero)


def slstm_decode(params, x, state, *, n_heads: int):
    xw = x[:, 0] @ params["w"].to(x.dtype)
    state = _slstm_cell(params, xw, state, n_heads)
    out = rmsnorm(params["out_norm"], state[0][:, None].to(x.dtype))
    return out, state
