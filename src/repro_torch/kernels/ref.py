"""Plain PyTorch versions of the kernels (counterpart of
`repro/kernels/ref.py`). They are the parity targets: the CPU route of
every kernel wrapper, and what `chip_smoke.py` holds each CUDA kernel
against on the card (`mode="oracle"`)."""
from __future__ import annotations

import math

import torch

from repro_torch.models import modules


def gru_cell_ref(x, h, w, u, b):
    """x: (M, Din), h: (M, D), w: (Din, 3D), u: (D, 3D), b: (3D,)."""
    return modules.gru_cell({"w": w, "u": u, "b": b}, x, h)


def pres_predict_ref(s_prev, delta_mean, dt, clip=5.0):
    """Eq. 7 extrapolation fill: s_prev + clip(dt * delta_mean)."""
    return s_prev + torch.clamp(dt[:, None] * delta_mean, -clip, clip)


def pres_filter_ref(s_prev, s_meas, delta_mean, dt, gamma, clip=5.0,
                    delta_mode="innovation"):
    """Predict (Eq. 7) -> correct (Eq. 8) -> delta rate. Returns
    (fused, delta_rate)."""
    s_pred = pres_predict_ref(s_prev, delta_mean, dt, clip=clip)
    fused = (1.0 - gamma) * s_pred + gamma * s_meas
    base = s_pred if delta_mode == "innovation" else s_prev
    delta = (fused - base) / torch.clamp(dt, min=1.0)[:, None]
    return fused, delta


def memory_update_ref(x, h, w, u, b, delta_mean, scale, gamma, clip=5.0,
                      delta_mode="innovation"):
    """GRU measurement -> PRES filter over the touched rows. Returns
    (s_meas, fused, delta_rate), each (M, D)."""
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
    aliases them) and returns (table, last_t, s_meas, fused, delta). Every
    row is gathered before any is written, and each valid node has one
    selected occurrence, so the writes are unique."""
    n = table.shape[0]
    g = gather_idx.long()
    ok = (g < n)[:, None]
    h = torch.where(ok, table[torch.clamp(g, max=n - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    s_meas, fused, delta = memory_update_ref(x, h, w, u, b, delta_mean,
                                             scale, gamma, clip=clip,
                                             delta_mode=delta_mode)
    wi = write_idx.long()
    sel = wi < n
    table[wi[sel]] = fused[sel].to(table.dtype)
    last_t[wi[sel]] = times[sel].to(last_t.dtype)
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
    h_nbr = tab[idx.reshape(-1).long()].reshape(r, kk, -1)
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
