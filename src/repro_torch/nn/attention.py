"""GQA attention with RoPE / M-RoPE, qk-norm, QKV bias, sliding windows
and KV-cache single-token decode (counterpart of `repro/nn/attention.py`).

Projection weights are 2-D with a fused (n_heads * d_head) output dim, as
in JAX; activations are reshaped to (B, S, H, D) inside. The long-prefill
branch, `blockwise_attention`, runs the `flash_attn` kernel
(`kernels/flash_attn.py`); the JAX package's lax version of it is the
function whose on-chip form that kernel is. With soft-capped scores that
branch is JAX's lax online softmax written in PyTorch: the Pallas kernel
takes no cap, so neither kernel does. `cross_attention` is whisper's
encoder-decoder attention (dense scores)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.nn.layers import rmsnorm, rmsnorm_init
from repro_torch.nn.module import ParamBuilder
from repro_torch.train import annotate

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., None].float() * freqs          # (B, S, d/2)
    return _rotate(x, angles)


def apply_mrope(x, positions, sections, theta: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL). x: (B, S, H, D); positions: (B, 3, S)
    for (t, h, w); sections: the frequency bands each coordinate turns,
    in order, summing to D / 2."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    angles_all = positions[..., None].float() * freqs       # (B, 3, S, d/2)
    parts, start = [], 0
    for m, sec in enumerate(sections):
        parts.append(angles_all[:, m, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))           # (B, S, d/2)


def _rotate(x, angles):
    """x's two halves turned by `angles` (B, S, D/2), in float32."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention parameterisation
# ---------------------------------------------------------------------------


def attention_init(b: ParamBuilder, name: str, d_model: int, n_heads: int,
                   n_kv_heads: int, d_head: int, qkv_bias: bool = False,
                   qk_norm: bool = False, out_bias: bool = False):
    sub = b.sub(name)
    sub.add("wq", (d_model, n_heads * d_head), ("embed", "heads"))
    sub.add("wk", (d_model, n_kv_heads * d_head), ("embed", "heads"))
    sub.add("wv", (d_model, n_kv_heads * d_head), ("embed", "heads"))
    sub.add("wo", (n_heads * d_head, d_model), ("heads", "embed"))
    if qkv_bias:
        sub.add("bq", (n_heads * d_head,), ("heads",), init="zeros")
        sub.add("bk", (n_kv_heads * d_head,), ("heads",), init="zeros")
        sub.add("bv", (n_kv_heads * d_head,), ("heads",), init="zeros")
    if out_bias:
        sub.add("bo", (d_model,), ("embed",), init="zeros")
    if qk_norm:
        rmsnorm_init(sub, "q_norm", d_head, axis="head_dim")
        rmsnorm_init(sub, "k_norm", d_head, axis="head_dim")


def _project_qkv(params, xq, xkv, d_head: int):
    dt = xq.dtype
    b_, s, _ = xq.shape
    t = xkv.shape[1]
    q = xq @ annotate.weights(params["wq"].to(dt))
    k = xkv @ annotate.weights(params["wk"].to(dt))
    v = xkv @ annotate.weights(params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = annotate.split_dim(q, -1, (q.shape[-1] // d_head, d_head))
    k = annotate.split_dim(k, -1, (k.shape[-1] // d_head, d_head))
    v = annotate.split_dim(v, -1, (v.shape[-1] // d_head, d_head))
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v


def _out_proj(params, out, dtype):
    b_, s = out.shape[:2]
    y = out.reshape(b_, s, -1) @ annotate.weights(params["wo"].to(dtype))
    if "bo" in params:
        y = y + params["bo"].to(dtype)
    return y


def _gqa_scores(q, k):
    """q: (B, S, H, D), k: (B, T, KV, D) -> scores (B, KV, G, S, T) in
    float32."""
    b_, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b_, s, kv, h // kv, d)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(),
                        k.float()) / math.sqrt(d)


def _gqa_out(probs, v, dtype):
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    b_, s, kv, g, d = out.shape
    return out.reshape(b_, s, kv * g, d).to(dtype)


def _dense_attention(q, k, v, dtype, *, cap=None, mask=None, bmask=None):
    """Dense GQA attention in float32: q (B, S, H, D), k / v (B, T, KV,
    D) -> (B, S, H, D) in `dtype`; scores (B, KV, G, S, T) tanh-capped by
    `cap`, masked where the plain bool `mask` (its trailing dims
    broadcast) or the per-batch `bmask` (leading dim B, broadcast) is
    False. On DTensors it runs on each rank's batch
    and head shards (`annotate.local`; the card's torch cannot flatten
    the GQA groups of sharded dims), or replicated with a `bmask`."""
    def core(q, k, v, bmask=None):
        scores = _gqa_scores(q, k)
        if cap is not None:  # logit soft-capping (gemma-style)
            scores = torch.tanh(scores / cap) * cap
        neg = torch.full((), NEG_INF, device=q.device)
        if mask is not None:
            scores = torch.where(mask, scores, neg)
        if bmask is not None:
            scores = torch.where(bmask, scores, neg)
        probs = torch.softmax(scores, dim=-1)
        return _gqa_out(probs, v, dtype)

    if bmask is not None:
        return annotate.local(core, q, k, v, bmask)
    return annotate.local(core, q, k, v, placements=annotate.group_placements(
        (q, k, v), (0, 2)))


def causal_mask(s: int, t: int, offset: int = 0, window: int | None = None,
                device=None):
    qpos = offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


# ---------------------------------------------------------------------------
# Blockwise (online-softmax) attention through the flash_attn kernel
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, *, causal: bool, window: int | None,
                        softmax_scale_cap: float | None,
                        mode: str | None = None, q_chunk: int = 2048,
                        kv_chunk: int = 1024):
    """q: (B, S, H, D), k/v: (B, T, KV, D) -> (B, S, H, D) in q.dtype.

    The query heads are laid out as (B * H, S, D) and the kv heads as
    (B * KV, T, D), so query head h of batch b reads kv head h // (H / KV)
    of the same b, and the `flash_attn` kernel runs them (the plain
    version for CPU tensors, or with mode="oracle"). The kernel's tiles
    are its own: `q_chunk` / `kv_chunk` are read only by the soft-capped
    branch (`_capped_blockwise`), which launches no kernel."""
    if softmax_scale_cap is not None:
        return _capped_blockwise(q, k, v, causal=causal, window=window,
                                 cap=softmax_scale_cap, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    def heads_first(q, k, v):
        b_, s, h, d = q.shape
        t, kv = k.shape[1], k.shape[2]
        qf = q.transpose(1, 2).reshape(b_ * h, s, d).contiguous()
        kf = k.transpose(1, 2).reshape(b_ * kv, t, d).contiguous()
        vf = v.transpose(1, 2).reshape(b_ * kv, t, d).contiguous()
        out = ops.flash_attn(qf, kf, vf, mode=mode, causal=causal,
                             window=window)
        return out.reshape(b_, h, s, d).transpose(1, 2).to(q.dtype)

    # on DTensors, on each rank's batch and head shards (the layout
    # changes above do not shard), replicated where a dim does not divide
    return annotate.local(heads_first, q, k, v,
                          placements=annotate.group_placements((q, k, v),
                                                               (0, 2)))


def _capped_blockwise(q, k, v, *, causal: bool, window: int | None,
                      cap: float, q_chunk: int, kv_chunk: int):
    """JAX's lax `blockwise_attention` with tanh-capped scores: q in
    chunks of `q_chunk`, for each a running max, sum and accumulator over
    kv chunks of `kv_chunk`, all in float32. No kernel takes a cap (the
    Pallas `flash_attn` has none), so this is plain PyTorch on every
    device."""
    b_, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, t)
    if s % q_chunk or t % kv_chunk:
        raise ValueError(f"blockwise_attention: S={s} and T={t} must be "
                         f"multiples of the chunks {q_chunk} and {kv_chunk}")
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=dev))
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    for iq in range(s // q_chunk):
        qc = q[:, iq * q_chunk:(iq + 1) * q_chunk].reshape(
            b_, q_chunk, kv, g, d).float()
        q_pos = iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b_, kv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b_, kv, g, q_chunk), device=dev)
        acc = torch.zeros((b_, kv, g, q_chunk, d), device=dev)
        for ik in range(t // kv_chunk):
            kc = k[:, ik * kv_chunk:(ik + 1) * kv_chunk].float()
            vc = v[:, ik * kv_chunk:(ik + 1) * kv_chunk].float()
            sc = torch.einsum("bqkgd,btkd->bkgqt", qc, kc) * scale
            sc = torch.tanh(sc / cap) * cap
            k_pos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            valid = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                               device=dev)
            if causal:
                valid &= k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                valid &= k_pos[None, :] > q_pos[:, None] - window
            sc = torch.where(valid[None, None, None], sc, neg)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkd->bkgqd",
                                                        p, vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KV,G,qc,D)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,qc,KV,G,D)
    return torch.cat(outs, dim=1).reshape(b_, s, h, d).to(q.dtype)


def attention(params, x, positions, *, d_head: int, causal: bool = True,
              window: int | None = None, rope_theta: float | None = 10000.0,
              mrope_sections=None, mrope_positions=None,
              softmax_scale_cap: float | None = None, attn_mask=None,
              chunk: int | None = None, mode: str | None = None):
    """Full-sequence (prefill) attention. x: (B, S, d).

    chunk: when set, S >= 2 * chunk, S % chunk == 0 and no attn_mask is
    given, the blockwise branch (the `flash_attn` kernel, routed by
    `mode`; with `softmax_scale_cap`, the capped online softmax in q
    chunks of `chunk` and kv chunks of max(chunk // 2, 128), as in JAX);
    otherwise dense scores in float32, as in JAX. With
    `mrope_sections`, q and k turn by M-RoPE at `mrope_positions`
    (B, 3, S) in place of RoPE at `positions`."""
    q, k, v = _project_qkv(params, x, x, d_head)
    if mrope_sections is not None:
        q = apply_mrope(q, mrope_positions, mrope_sections, rope_theta)
        k = apply_mrope(k, mrope_positions, mrope_sections, rope_theta)
    elif positions is not None and rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    s = x.shape[1]
    if (chunk is not None and attn_mask is None and s >= 2 * chunk
            and s % chunk == 0):
        out = blockwise_attention(q, k, v, causal=causal, window=window,
                                  softmax_scale_cap=softmax_scale_cap,
                                  mode=mode, q_chunk=chunk,
                                  kv_chunk=max(chunk // 2, 128))
        return _out_proj(params, out, x.dtype)
    mask = (causal_mask(s, s, window=window, device=x.device)
            if causal else None)
    out = _dense_attention(
        q, k, v, x.dtype, cap=softmax_scale_cap, mask=mask,
        bmask=None if attn_mask is None else attn_mask[:, None, None])
    return _out_proj(params, out, x.dtype)


def cross_attention(params, x, kv_src, *, d_head: int, src_mask=None):
    """Encoder-decoder cross attention: queries from x (B, S, d), keys
    and values from kv_src (B, T, d); src_mask (B, T) bool masks source
    positions. Dense scores in float32, no RoPE."""
    q, k, v = _project_qkv(params, x, kv_src, d_head)
    out = _dense_attention(
        q, k, v, x.dtype,
        bmask=None if src_mask is None else src_mask[:, None, None, None, :])
    return _out_proj(params, out, x.dtype)


# ---------------------------------------------------------------------------
# KV cache — decode path
# ---------------------------------------------------------------------------


# the logical axes of a KV cache's leaves (init_cache's)
CACHE_AXES = {
    "k": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
}


def init_cache(batch: int, cache_len: int, n_kv: int, d_head: int,
               dtype=torch.bfloat16, device=None):
    shape = (batch, cache_len, n_kv, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x, cache, pos: int, *, d_head: int,
                     window: int | None = None,
                     rope_theta: float | None = 10000.0,
                     mrope_sections=None, mrope_positions=None,
                     softmax_scale_cap: float | None = None):
    """One-token decode. x: (B, 1, d); pos: the token's position (int).

    For windowed layers the cache is a ring buffer (write slot pos %
    cache_len); a global layer writes slot pos and raises ValueError when
    pos >= cache_len (the JAX version's dynamic_update_slice clamps the
    slot to the last one instead). The new k and v are written into
    `cache` IN PLACE (the JAX version returns updated copies; an
    8,192-slot cache would be copied every step); returns (y, cache).
    With `mrope_sections`, q and k turn by M-RoPE at `mrope_positions`
    (B, 3, 1)."""
    b_, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode_attention takes one token, got S={s}")
    pos = int(pos)
    cache_len = cache["k"].shape[1]
    if window is None and not 0 <= pos < cache_len:
        raise ValueError(f"decode_attention: position {pos} is outside the "
                         f"cache of a global layer (cache_len {cache_len})")
    q, k, v = _project_qkv(params, x, x, d_head)
    if mrope_sections is not None:
        q = apply_mrope(q, mrope_positions, mrope_sections, rope_theta)
        k = apply_mrope(k, mrope_positions, mrope_sections, rope_theta)
    elif rope_theta is not None:
        posv = torch.full((b_, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    ck, cv = cache["k"], cache["v"]
    slot = pos % cache_len if window is not None else pos
    # on a DTensor cache, only the shard that holds the slot writes
    annotate.write_index(ck, 1, slot, k[:, 0].to(ck.dtype))
    annotate.write_index(cv, 1, slot, v[:, 0].to(cv.dtype))
    kpos = torch.arange(cache_len, device=x.device)
    if window is not None:
        # ring buffer: slot j holds absolute position pos - ((slot - j) mod L)
        abs_pos = pos - torch.remainder(slot - kpos, cache_len)
        valid = (abs_pos >= max(0, pos - window + 1)) & (abs_pos <= pos)
    else:
        valid = kpos <= pos
    out = _dense_attention(q, ck, cv, x.dtype, cap=softmax_scale_cap,
                           mask=valid)
    return _out_proj(params, out, x.dtype), cache
