"""Plain PyTorch versions of the kernels (counterpart of
`repro/kernels/ref.py`). They are the parity targets: the CPU route of
every kernel wrapper, and what `chip_smoke.py` holds each CUDA kernel
against on the card (`mode="oracle"`)."""
from __future__ import annotations

import math

import torch

from repro_torch.core import batching
from repro_torch.models import modules


def gru_cell_ref(x, h, w, u, b):
    """x: (M, Din), h: (M, D), w: (Din, 3D), u: (D, 3D), b: (3D,)."""
    return modules.gru_cell({"w": w, "u": u, "b": b}, x, h)


def _clip(a, lo=None, hi=None):
    """Clamp with jnp.maximum / jnp.minimum's gradient: half to each side
    on a tie (torch.clamp passes all of it), so the gradients match
    jax.vjp's where a value sits exactly on a bound."""
    if lo is not None:
        a = torch.maximum(a, torch.full_like(a, lo))
    if hi is not None:
        a = torch.minimum(a, torch.full_like(a, hi))
    return a


def pres_predict_ref(s_prev, delta_mean, dt, clip=5.0):
    """Eq. 7 extrapolation fill: s_prev + clip(dt * delta_mean)."""
    return s_prev + _clip(dt[:, None] * delta_mean, -clip, clip)


def pres_filter_ref(s_prev, s_meas, delta_mean, dt, gamma, clip=5.0,
                    delta_mode="innovation"):
    """Predict (Eq. 7) -> correct (Eq. 8) -> delta rate. Returns
    (fused, delta_rate)."""
    s_pred = pres_predict_ref(s_prev, delta_mean, dt, clip=clip)
    fused = (1.0 - gamma) * s_pred + gamma * s_meas
    base = s_pred if delta_mode == "innovation" else s_prev
    delta = (fused - base) / _clip(dt, lo=1.0)[:, None]
    return fused, delta


def memory_update_ref(x, h, w, u, b, delta_mean, scale, gamma, clip=5.0,
                      delta_mode="innovation"):
    """GRU measurement -> PRES filter over the touched rows. Returns
    (s_meas, fused, delta_rate), each (M, D) float32; bfloat16 rows h are
    widened to float32 first, as the JAX kernel casts them on load."""
    h = h.float()
    s_meas = gru_cell_ref(x, h, w, u, b)
    fused, delta = pres_filter_ref(h, s_meas, delta_mean, scale, gamma,
                                   clip=clip, delta_mode=delta_mode)
    return s_meas, fused, delta


def memory_update_table_ref(table, last_t, x, gather_idx, write_idx, times,
                            w, u, b, delta_mean, scale, gamma, clip=5.0,
                            delta_mode="innovation"):
    """Gather the previous rows at gather_idx (any index >= N reads zeros),
    run memory_update_ref on them, then write the fused rows and their
    times into `table` / `last_t` at write_idx (indices >= N are dropped).

    Updates `table` and `last_t` IN PLACE (the JAX version donates and
    aliases them) and returns (table, last_t, s_meas, fused, delta). A
    bfloat16 table's rows are widened to float32 for the math and the
    fused rows rounded to bfloat16 (nearest, ties to even) as they are
    written, as the JAX kernel casts on load and store. Every
    row is gathered before any is written, and each valid node has one
    selected occurrence, so the kept writes are unique. The writes are
    `batching.write_selected`'s: one write of fixed shape over all M
    positions, no boolean-mask index, so the plain version waits for
    nothing on the host either (a CUDA graph holds it)."""
    n = table.shape[0]
    g = gather_idx.long()
    ok = (g < n)[:, None]
    h = torch.where(ok, table[torch.clamp(g, max=n - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    s_meas, fused, delta = memory_update_ref(x, h.float(), w, u, b, delta_mean,
                                             scale, gamma, clip=clip,
                                             delta_mode=delta_mode)
    wi = write_idx.long()
    batching.write_selected(table, wi, wi < n, fused)
    batching.write_selected(last_t, wi, wi < n, times)
    return table, last_t, s_meas, fused, delta


def link_score_ref(h_src, h_items, w1, b1, w2, b2):
    """(B, I) link-decoder scores of every (source, item) pair:
    relu(h_src @ w1[:D] + h_items @ w1[D:] + b1) @ w2 + b2."""
    d = h_src.shape[-1]
    a = h_src.float() @ w1[:d]
    c = h_items.float() @ w1[d:]
    hidden = torch.relu(a[:, None, :] + c[None, :, :] + b1)
    return (hidden @ w2)[..., 0] + b2[0]


def neighbor_attn_ref(q, k, v, valid):
    """Masked single-head attention over K slots.
    q: (M, E), k/v: (M, K, E), valid: (M, K) bool -> (M, E)."""
    scores = torch.einsum("me,mke->mk", q, k) / math.sqrt(q.shape[-1])
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores.float(), dim=-1)
    probs = torch.where(valid.any(-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    return torch.einsum("mk,mke->me", probs.to(q.dtype), v)


def embed_attn_ref(h_self, tab, idx, dt, valid, tw, tb, wq, wk, wv,
                   n_heads=1):
    """Deduplicated embedding layer: gather each row's K neighbour rows
    from the unique table at idx, append cos(dt * tw + tb), project Q/K/V
    and run the masked multi-head attention. Returns (R, E) before the
    output projection."""
    r, kk = valid.shape
    # index_select: its backward (index_add_) stays fast when many slots
    # share a row (every invalid slot points at one row of `tab`)
    h_nbr = tab.index_select(0, idx.reshape(-1).long()).reshape(r, kk, -1)
    t_enc = modules.time_encode({"w": tw, "b": tb}, dt)
    kv = torch.cat([h_nbr, t_enc], dim=-1)
    q = h_self @ wq
    k = kv @ wk
    v = kv @ wv
    e = q.shape[-1]
    if n_heads > 1:
        dh = e // n_heads
        q = q.reshape(r * n_heads, dh)
        k = (k.reshape(r, kk, n_heads, dh).transpose(1, 2)
             .reshape(r * n_heads, kk, dh))
        v = (v.reshape(r, kk, n_heads, dh).transpose(1, 2)
             .reshape(r * n_heads, kk, dh))
        valid = torch.repeat_interleave(valid, n_heads, dim=0)
    agg = neighbor_attn_ref(q, k, v, valid)
    if n_heads > 1:
        agg = agg.reshape(r, e)
    return agg


NEG_INF = -1e30


# float32 score bytes `flash_attn_ref` forms at once: a larger problem
# runs a slice of its query groups at a time (each group's softmax is its
# own). kimi-k2's 64 heads at S = T = 8,192 are 17 GB of scores a tensor,
# and the dense form keeps three such tensors beside 40 GB of weights.
REF_SCORE_BYTES = 1 << 31


def flash_attn_ref(q, k, v, causal=True, window=None):
    """Dense attention. q: (G, S, D); k, v: (Gkv, T, D) with G % Gkv == 0,
    query group g reading kv group g // (G / Gkv). Scores in float32,
    scaled by 1/sqrt(D) after the product, masked (k_pos <= q_pos when
    causal, k_pos > q_pos - window when windowed) to -1e30; output in
    q's dtype. Query groups go a slice at a time when their scores would
    exceed REF_SCORE_BYTES (meta tensors, which hold no memory, in one
    slice)."""
    d = q.shape[-1]
    g, s, t = q.shape[0], q.shape[1], k.shape[1]
    n_rep = g // k.shape[0]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=0)
        v = torch.repeat_interleave(v, n_rep, dim=0)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    valid = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    step = (g if q.device.type == "meta"
            else max(1, REF_SCORE_BYTES // (4 * s * t)))
    outs = []
    for g0 in range(0, g, step):
        sl = slice(g0, g0 + step)
        scores = torch.einsum("gsd,gtd->gst", q[sl].float(),
                              k[sl].float()) / (d ** 0.5)
        scores = torch.where(valid[None], scores,
                             torch.full((), NEG_INF, device=q.device))
        probs = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("gst,gtd->gsd", probs,
                                 v[sl].float()).to(q.dtype))
        del scores, probs
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def bf16_excess(got, want32, tol):
    """The largest |got - want32| beyond one bf16 ulp of want32 plus the
    fp32 tolerance tol * max(1, max|want32|) (the reference rounds a value
    that is itself within the fp32 tolerance), and the largest
    |got - want32|: a bf16 output agrees when the first is <= 0."""
    got, want32 = got.float(), want32.float()
    mag = want32.abs().clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (got - want32).abs()
    slack = tol * max(1.0, float(want32.abs().max()))
    return float((diff - ulp - slack).max()), float(diff.max())


def ssd_chunk_ref(q, k, v, lcum, h0):
    """One SSD / mLSTM chunk for each of G groups, in float32.
    q, k: (G, L, N); v: (G, L, P); lcum: (G, L) inclusive cumulative
    log-decay; h0: (G, N, P) carried state. Returns (y (G, L, P),
    h1 (G, N, P)):
        y  = ((q k^T) * exp(lcum_i - lcum_j) [j <= i]) v + (q * exp(lcum)) h0
        h1 = exp(ltot) h0 + (k * exp(ltot - lcum))^T v
    The decay above the diagonal is zeroed before the exp as well as
    after it, so a large gap cannot overflow into the gradient (the
    forward is the JAX oracle's)."""
    ltot = lcum[:, -1]
    scores = q @ k.transpose(1, 2)                       # (G, L, L)
    decay = lcum[:, :, None] - lcum[:, None, :]
    ll = q.shape[1]
    mask = torch.tril(torch.ones((ll, ll), dtype=torch.bool,
                                 device=q.device))
    zero = torch.zeros((), dtype=scores.dtype, device=q.device)
    sdk = torch.where(mask, scores * torch.exp(torch.where(mask, decay, zero)),
                      zero)
    y = sdk @ v + (q * torch.exp(lcum)[:, :, None]) @ h0
    w = torch.exp(ltot[:, None] - lcum)
    h1 = h0 * torch.exp(ltot)[:, None, None] + (k * w[:, :, None]).transpose(
        1, 2) @ v
    return y, h1
