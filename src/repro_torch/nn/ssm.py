"""Linear-recurrence substrate of the model zoo (counterpart of
`repro/nn/ssm.py`): the chunked (SSD-style) algorithm for

    H_t = a_t * H_{t-1} + k_t v_t^T          (H: N x P matrix state per head)
    y_t = q_t^T H_t

which covers Mamba2 (q = C, k = dt * B, v = x, a = exp(-exp(A_log) dt))
and mLSTM (q, k, v projections; a = the forget gate). Each chunk's
quadratic work is one launch of the `ssd_chunk` kernel over the
(batch x heads) groups; the inter-chunk state is carried by a Python loop
over the chunks (JAX's `lax.scan`). The Mamba2 block (zamba2's backbone)
is below."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.module import ParamBuilder
from repro_torch.train import annotate


def chunked_linear_rnn(q, k, v, log_a, *, chunk: int = 256, init_state=None,
                       mode: str | None = None):
    """q, k: (B, S, H, N); v: (B, S, H, P); log_a: (B, S, H) (log of the
    decay in (0, 1]). Returns y (B, S, H, P) and the final state
    (B, H, N, P), both float32.

    S is padded to a multiple of `chunk` with zeros (log_a 0: no decay).
    Within a chunk the kernel weighs the future terms exactly 0, where
    the JAX lax version weighs them by exp(-30) (ROADMAP Queue 3 P22).
    On DTensors the chunk loop runs on each rank's batch and head shards
    (`annotate.local`; replicated where a dim does not divide), the state
    carried as (B, N, H, P) so that its head dim is the others' dim 2."""
    b, _, h, n = q.shape
    if init_state is None:
        init_state = torch.zeros((b, h, n, v.shape[-1]), dtype=torch.float32,
                                 device=q.device)
    args = (q, k, v, log_a, init_state.transpose(1, 2))
    y, state = annotate.local(
        functools.partial(_chunk_loop, chunk=chunk, mode=mode), *args,
        placements=annotate.group_placements(args, (0, 2)))
    return y, state.transpose(1, 2)


def _chunk_loop(q, k, v, log_a, state_t, *, chunk: int, mode):
    """chunked_linear_rnn on plain tensors, the state in and out as (B, N,
    H, P)."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    nc = q.shape[1] // chunk
    state = state_t.transpose(1, 2).float().reshape(b * h, n, p)

    def groups(x, c):
        """Chunk c of a (B, S, H, W) tensor as (B * H, chunk, W) fp32."""
        x = x[:, c * chunk:(c + 1) * chunk].float()
        return x.transpose(1, 2).reshape(b * h, chunk, -1).contiguous()

    ys = []
    for c in range(nc):
        la = log_a[:, c * chunk:(c + 1) * chunk].float()     # (B, L, H)
        lcum = torch.cumsum(la, dim=1).transpose(1, 2).reshape(b * h, chunk)
        y, state = ops.ssd_chunk(groups(q, c), groups(k, c), groups(v, c),
                                 lcum.contiguous(), state, mode=mode)
        ys.append(y.reshape(b, h, chunk, p).transpose(1, 2))
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state.reshape(b, h, n, p).transpose(1, 2)


def linear_rnn_step(state, q, k, v, log_a):
    """One decode step. state: (B, H, N, P); q, k: (B, H, N); v: (B, H, P).
    Returns (state, y (B, H, P))."""
    a = torch.exp(log_a.float())[..., None, None]
    state = state * a + torch.einsum("bhn,bhp->bhnp", k.float(), v.float())
    y = torch.einsum("bhn,bhnp->bhp", q.float(), state)
    return state, y


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_init(b: ParamBuilder, name: str, d_model: int, d_state: int, *,
                expand: int = 2, head_dim: int = 64, conv_width: int = 4):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    sub = b.sub(name)
    sub.add("in_proj", (d_model, 2 * d_inner + 2 * d_state + n_heads),
            ("embed", "mlp"))
    sub.add("conv_w", (conv_width, d_inner + 2 * d_state), ("conv", "mlp"))
    sub.add("conv_b", (d_inner + 2 * d_state,), ("mlp",), init="zeros")
    sub.add("A_log", (n_heads,), ("heads",), init="zeros")
    sub.add("dt_bias", (n_heads,), ("heads",), init="zeros")
    sub.add("D", (n_heads,), ("heads",), init="ones")
    sub.add("norm_scale", (d_inner,), ("mlp",), init="ones")
    sub.add("out_proj", (d_inner, d_model), ("mlp", "embed"))


def _softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` computes it (logaddexp(x, 0));
    F.softplus returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (W, C): the W shifted
    slices weighted and summed in x's dtype, in order, then b."""
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _split(x, d_inner, d_state):
    """in_proj's output -> (z, xBC, dt)."""
    return torch.split(x, [d_inner, d_inner + 2 * d_state,
                           x.shape[-1] - 2 * d_inner - 2 * d_state], dim=-1)


def _gated_norm(norm_scale, y, z, dtype):
    """y * silu(z), then the gated RMSNorm (1e-6 inside the rsqrt)."""
    y = y.to(dtype) * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + 1e-6) * norm_scale).to(dtype)


def _gated_out(params, y, z, dtype):
    """The gated RMSNorm, then out_proj."""
    return (_gated_norm(params["norm_scale"], y, z, dtype)
            @ params["out_proj"].to(dtype))


# the block's small weights, between its two projections
_MIDDLE = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_scale")


def mamba2(params, x, *, d_state: int, head_dim: int = 64, chunk: int = 256,
           init_state=None, return_state: bool = False,
           mode: str | None = None):
    """x: (B, S, d). Returns y (B, S, d) [and the final SSM state
    (B, H, N, P)]; the recurrence runs through `chunked_linear_rnn`, one
    `ssd_chunk` launch a chunk (routed by `mode`). On DTensors the block
    between its two projections runs on each rank's batch shard
    (`annotate.local`, its small weights whole): the card's torch (2.11)
    mislays the placements of the conv's pad or the splits of a
    DTensor."""
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    dtype = x.dtype

    def middle(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
               init_state=None):
        b_, s, _ = zxbcdt.shape              # this rank's batch shard
        z, xbc, dt = _split(zxbcdt, d_inner, d_state)
        xbc = _causal_conv(F.silu(xbc), conv_w.to(dtype), conv_b.to(dtype))
        xs, b_ssm, c_ssm = torch.split(xbc, [d_inner, d_state, d_state],
                                       dim=-1)
        dt = _softplus(dt.float() + dt_bias)                # (B, S, H)
        a = -torch.exp(a_log.float())                       # (H,) negative
        log_decay = a * dt                                  # log exp(a dt)
        xh = xs.reshape(b_, s, n_heads, head_dim)
        k = b_ssm[:, :, None, :].expand(b_, s, n_heads, d_state) \
            * dt[..., None]
        q = c_ssm[:, :, None, :].expand(b_, s, n_heads, d_state)
        y, state = chunked_linear_rnn(q, k, xh, log_decay, chunk=chunk,
                                      init_state=init_state, mode=mode)
        y = y + d_skip.float()[None, None, :, None] * xh.float()
        return _gated_norm(norm_scale, y.reshape(b_, s, d_inner), z,
                           dtype), state

    zxbcdt = x @ params["in_proj"].to(dtype)
    y, state = annotate.local(
        middle, zxbcdt, *(params[n] for n in _MIDDLE), init_state=init_state,
        placements=annotate.group_placements((zxbcdt,), (0,)),
        whole=range(1, 1 + len(_MIDDLE)))
    out = y @ params["out_proj"].to(dtype)
    return (out, state) if return_state else out


def mamba2_decode_init(batch: int, params, d_state: int, head_dim: int = 64):
    """Zero decode state on the parameters' device: the SSM state
    (B, H, N, P) and the conv ring of the last width - 1 inputs
    (B, W - 1, C), both float32."""
    n_heads = params["A_log"].shape[0]
    conv_dim = n_heads * head_dim + 2 * d_state
    width = params["conv_w"].shape[0]
    dev = params["A_log"].device
    return {"ssm": torch.zeros((batch, n_heads, d_state, head_dim),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, width - 1, conv_dim),
                                dtype=torch.float32, device=dev)}


# the logical axes of mamba2_decode_init's state
MAMBA_STATE_AXES = {"ssm": ("batch", "heads", "state", "head_dim"),
                    "conv": ("batch", None, "mlp")}


def mamba2_decode(params, x, state, *, d_state: int, head_dim: int = 64):
    """One-token decode. x: (B, 1, d). Returns (y (B, 1, d), the new
    state); `state` is not written."""
    b_ = x.shape[0]
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    z, xbc, dt = _split(x[:, 0] @ params["in_proj"].to(x.dtype), d_inner,
                        d_state)
    xbc = F.silu(xbc)
    # the conv over the ring of previous inputs
    hist = torch.cat([state["conv"], xbc[:, None].float()], dim=1)
    conv_out = (torch.einsum("bwc,wc->bc", hist, params["conv_w"].float())
                + params["conv_b"])
    xs, b_ssm, c_ssm = torch.split(conv_out.to(x.dtype),
                                   [d_inner, d_state, d_state], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"])          # (B, H)
    a = -torch.exp(params["A_log"].float())
    xh = xs.reshape(b_, n_heads, head_dim)
    k = b_ssm[:, None, :].expand(b_, n_heads, d_state) * dt[..., None]
    q = c_ssm[:, None, :].expand(b_, n_heads, d_state)
    ssm_state, y = linear_rnn_step(state["ssm"], q, k, xh, a * dt)
    y = y + params["D"][None, :, None] * xh.float()
    out = _gated_out(params, y.reshape(b_, d_inner), z, x.dtype)
    return out[:, None], {"ssm": ssm_state, "conv": hist[:, 1:]}
