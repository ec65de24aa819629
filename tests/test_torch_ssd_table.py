"""The numerics of the port's `ssd_chunk` and memory-table kernels
(`kernels/csrc/ssd_chunk.cu`, `kernels/csrc/memory_update.cu` on the GRU
tile of `kernels/csrc/gru_tile.cuh`), which run only on the card, held on
the CPU.

Both kernels run their matrix products on the tensor cores at fp32 grade:
each operand split into hi = tf32(x) and lo = tf32(x - hi) (rounded as
`cvt.rna.tf32.f32` rounds), three TF32 products a step, each 8-deep step
accumulated in fp32 (`_mm3` of `test_torch_gru_embed.py`). `_ssd` repeats
`ssd_chunk`'s order in plain PyTorch (test code: nothing on the port's
path calls it): the carry-in (q * exp(lcum)) h0 first, then for each
32-key tile the scores q k^T, rounded, times their decay exp(lcum_i -
lcum_j), rounded, 0 above the diagonal, restaged and multiplied by the
tile's rows of v into the same accumulator; h1 = exp(ltot) h0 +
(k * exp(ltot - lcum))^T v, each scaling rounded before its split. A
block's two halves of warps take alternate halves of every depth chunk
(N in 32- and 128-deep chunks, L in 32-deep ones), and their partial sums
are added, half 0's first.
`_table` repeats the table kernel: the gathered rows (zeros for a masked
index), the GRU tile's two depth halves and gate epilogue (`_gru`), the
PRES filter rounded op by op as its plain version (`pres_rows.cuh`), then
the scatter of the selected rows and their times; the dense
`memory_update` is the same without the gather and the scatter.

The emulations are held against the JAX package's Pallas kernels in
interpret mode and its jitted refs on the same numpy inputs, within
`chip_smoke.py`'s `TOL` (each output within TOL * max(1, max|ref|)), at
`chip_smoke.py`'s edge shapes, the xLSTM widths (G = 8, L = 256, N = 256,
P = 257) and M = 2,048, D = Din = 128; `last_t` and the rows the scatter
leaves alone exactly. A single TF32 rounding of each operand misses `TOL`
at the full widths of both kernels: why they split."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import memory_update as jmu
from repro.kernels import ref as jref
from repro.kernels import ssd_chunk as jssd

from repro_torch.kernels import ref
from repro_torch.models import mdgnn
from test_torch_gru_embed import _err, _gru, _mm3

TOL = {"memory_update_table": 1e-5, "memory_update": 1e-5,
       "ssd_chunk": 1e-5}   # chip_smoke.TOL
SSD_BK = 32         # ssd_chunk.cu: keys a tile, depth of an h1 chunk
SSD_KS = 128        # depth over N of a score chunk
SSD_KC = 32         # depth over N of a carry-in chunk


def _half(n, chunk, h):
    """The depth indices below n that half h of a block's warps takes: the
    h-th half of every `chunk`-deep chunk, in order."""
    return torch.tensor([i for c0 in range(0, n, chunk)
                         for i in range(c0 + h * chunk // 2,
                                        min(c0 + (h + 1) * chunk // 2, n))],
                        dtype=torch.long)


def _ssd(q, k, v, lcum, h0, split=True):
    """ssd_chunk.cu's arithmetic over G groups (see the module docstring):
    each sum split over the block's two depth halves, added at the end."""
    _, ll, n = q.shape
    qs = q * torch.exp(lcum)[..., None]
    ys = [_mm3(qs[..., i], h0[:, i], split)
          for i in (_half(n, SSD_KC, h) for h in (0, 1))]
    rows = torch.arange(ll)[:, None]
    for j0 in range(0, ll, SSD_BK):
        kt, vt = k[:, j0:j0 + SSD_BK], v[:, j0:j0 + SSD_BK]
        parts = [_mm3(q[..., i], kt[..., i].transpose(1, 2).contiguous(),
                      split) for i in (_half(n, SSD_KS, h) for h in (0, 1))]
        keys = torch.arange(j0, j0 + kt.shape[1])[None]
        dec = torch.exp(lcum[:, :, None] - lcum[:, None, j0:j0 + SSD_BK])
        s = torch.where(keys <= rows, (parts[0] + parts[1]) * dec,
                        torch.zeros(()))
        for h in (0, 1):
            i = _half(kt.shape[1], SSD_BK, h)
            ys[h] = _mm3(s[..., i], vt[:, i], split, ys[h])
    ltot = lcum[:, -1]
    kw = (k * torch.exp(ltot[:, None] - lcum)[..., None]).transpose(1, 2)
    hs = [_mm3(kw[..., i].contiguous(), v[:, i], split)
          for i in (_half(ll, SSD_BK, h) for h in (0, 1))]
    h1 = h0 * torch.exp(ltot)[:, None, None] + (hs[0] + hs[1])
    return ys[0] + ys[1], h1


def _rows(x, h, w, u, b, dmean, scale, gamma, clip, mode, split=True):
    """The rows kernel: the GRU tile, then the filter on its registers."""
    s_meas = _gru(x, h, w, u, b, split)
    fused, delta = ref.pres_filter_ref(h, s_meas, dmean, scale, gamma,
                                       clip=clip, delta_mode=mode)
    return s_meas, fused, delta


def _table(table, last_t, x, gidx, widx, times, w, u, b, dmean, scale,
           gamma, clip, mode, split=True):
    """Phase 1 (gather, rows kernel) and phase 2 (the scatter)."""
    n = table.shape[0]
    g = gidx.long()
    ok = ((g >= 0) & (g < n))[:, None]
    h = torch.where(ok, table[g.clamp(0, n - 1)], torch.zeros(()))
    s_meas, fused, delta = _rows(x, h, w, u, b, dmean, scale, gamma, clip,
                                 mode, split)
    table, last_t = table.clone(), last_t.clone()
    wi = widx.long()
    sel = wi < n
    table[wi[sel]] = fused[sel]
    last_t[wi[sel]] = times[sel]
    return table, last_t, s_meas, fused, delta


def _draw(rng, *shape, sc=1.0):
    return (rng.normal(size=shape) * sc).astype(np.float32)


def _check(got, wants, tol, exact=()):
    for want in wants:
        for i, (g_, w_) in enumerate(zip(got, want)):
            if i in exact:
                assert np.array_equal(g_.numpy(), np.asarray(w_)), i
                continue
            err, scale = _err(g_, w_)
            assert err <= tol * scale, f"output {i}: max|diff| {err:.3g}"


# ssd_chunk: chip_smoke.py's edge shapes (G, L, N, P, lcum step scale):
# L = 1, ragged L, the xLSTM widths at G = 8 and 1, a large negative lcum,
# P = 400 (three slabs), N = 33, L = 64 with P = 8, L = 65 with P = 264,
# G = 3 with L P and N P odd (later groups off 16-byte boundaries)
SSD_EDGE = [(1, 1, 8, 9, 0.05), (3, 100, 16, 17, 0.05),
            (8, 256, 256, 257, 0.05), (2, 300, 64, 65, 0.05),
            (2, 256, 256, 257, 4.0), (1, 40, 33, 400, 0.5),
            (2, 64, 64, 8, 0.05), (1, 65, 40, 264, 0.05),
            (1, 256, 256, 257, 0.05), (3, 3, 33, 9, 0.05),
            (3, 51, 64, 257, 0.05)]


def _ssd_inputs(case):
    g, ll, n, p, lsc = case
    rng = np.random.default_rng(g + 3 * ll + 5 * n + 7 * p)
    lcum = np.cumsum(-np.abs(_draw(rng, g, ll, sc=lsc)), -1).astype(
        np.float32)
    return [_draw(rng, g, ll, n, sc=0.1), _draw(rng, g, ll, n, sc=0.1),
            _draw(rng, g, ll, p, sc=0.5), lcum, _draw(rng, g, n, p, sc=0.5)]


@functools.lru_cache(maxsize=None)
def _ssd_jax():
    return jax.jit(jax.vmap(jref.ssd_chunk_ref))


@pytest.mark.parametrize("case", SSD_EDGE, ids=[
    "G{}_L{}_N{}_P{}_s{}".format(*c) for c in SSD_EDGE])
def test_ssd_chunk_3xtf32_matches_jax(case):
    args = _ssd_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    got = _ssd(*[torch.as_tensor(a) for a in args])
    g, ll, n, p, _ = case
    assert got[0].shape == (g, ll, p) and got[1].shape == (g, n, p)
    assert all(bool(torch.isfinite(o).all()) for o in got)
    _check(got, (_ssd_jax()(*jargs),
                 jssd._ssd_chunk_pallas(*jargs, interpret=True)),
           TOL["ssd_chunk"])


def test_ssd_chunk_one_tf32_rounding_misses_tol():
    """tf32(a) tf32(b) alone, at the xLSTM widths."""
    args = _ssd_inputs((8, 256, 256, 257, 0.05))
    want = _ssd_jax()(*[jnp.asarray(a) for a in args])
    got = _ssd(*[torch.as_tensor(a) for a in args], split=False)
    errs = [_err(g_, w_) for g_, w_ in zip(got, want)]
    assert max(e / (TOL["ssd_chunk"] * s) for e, s in errs) > 1.0, errs


# memory_update_table: chip_smoke.py's edge shapes (M, N, D, Din, masked
# share, hot occurrences, rows forced masked): a hot node, masked rows,
# M = 1, Din != D, M = 65, M = 2,048 at D = Din = 128 with the hot node
# across a 64-row tile edge and masked rows on tiles' first and last rows,
# D = 12 with Din = 20 over three tiles
TABLE_EDGE = [(200, 50, 16, 24, 0.0, 70, ()), (24, 10, 8, 8, 0.4, 0, ()),
              (1, 5, 8, 8, 0, 0, ()), (12, 30, 100, 100, 0.2, 3, ()),
              (16, 9, 12, 20, 0.1, 5, ()), (65, 40, 128, 128, 0.1, 9, ()),
              (2048, 500, 128, 128, 0.05, 150, (0, 63, 64, 127, 2047)),
              (150, 60, 12, 20, 0.1, 20, (0, 63, 64))]


def _table_inputs(case):
    m, n, d, din, mfrac, hot, edge_rows = case
    rng = np.random.default_rng(m + 3 * n + 5 * d + 7 * din)
    nodes = rng.integers(0, n, m)
    if hot:
        nodes[rng.choice(m, hot, replace=False)] = 7 % n
    times = np.round(rng.random(m) * 5).astype(np.float32)
    mask = rng.random(m) >= mfrac
    tn, tt, tm = (torch.as_tensor(nodes), torch.as_tensor(times),
                  torch.as_tensor(mask))
    order = mdgnn.occurrence_order(tn, tt, tm)
    sel = mdgnn._last_occurrence_flags(tn, tt, tm)
    gidx = torch.where(tm, tn, n + 1)[order].to(torch.int32).numpy()
    widx = torch.where(sel, tn, n)[order].to(torch.int32).numpy()
    gidx[list(edge_rows)] = n + 1
    widx[list(edge_rows)] = n
    return [_draw(rng, n, d, sc=0.5), _draw(rng, n), _draw(rng, m, din),
            gidx, widx, tt[order].numpy(),
            _draw(rng, din, 3 * d, sc=din ** -0.5),
            _draw(rng, d, 3 * d, sc=d ** -0.5), _draw(rng, 3 * d, sc=0.1),
            _draw(rng, m, d, sc=0.3),
            np.round(rng.random(m) * 3).astype(np.float32),
            np.float32(0.37)]


def _table_jax(args, clip, mode):
    jargs = [jnp.asarray(a) for a in args]
    kw = dict(clip=clip, delta_mode=mode)
    return (jax.jit(functools.partial(jref.memory_update_table_ref, **kw))(
                *jargs),
            jmu._memory_update_table_pallas(*jargs, interpret=True, **kw))


@pytest.mark.parametrize("case", TABLE_EDGE, ids=[
    "M{}_N{}_D{}_Din{}".format(*c[:4]) + ("_edges" if c[6] else "")
    for c in TABLE_EDGE])
def test_memory_update_table_3xtf32_matches_jax(case):
    args = _table_inputs(case)
    if case[5] > 64:
        # the hot node's occurrences straddle a 64-row tile edge
        hot = np.flatnonzero(args[3] == 7 % case[1])
        assert hot.min() // 64 != hot.max() // 64
    got = _table(*[torch.as_tensor(a) for a in args], clip=1.0,
                 mode="transition")
    _check(got, _table_jax(args, 1.0, "transition"),
           TOL["memory_update_table"], exact=(1,))
    untouched = np.setdiff1d(np.arange(case[1]), args[4])
    assert np.array_equal(got[0].numpy()[untouched], args[0][untouched])


def test_memory_update_table_one_tf32_rounding_misses_tol():
    """tf32(a) tf32(b) alone, at M = 2,048, D = Din = 128."""
    args = _table_inputs(TABLE_EDGE[6])
    want = _table_jax(args, 1.0, "transition")[0]
    got = _table(*[torch.as_tensor(a) for a in args], clip=1.0,
                 mode="transition", split=False)
    err, scale = _err(got[2], want[2])      # s_meas
    assert err > TOL["memory_update_table"] * scale, f"max|diff| {err:.3g}"


# memory_update (dense): chip_smoke.py's edge shapes (M, D, Din), both
# delta modes: M = 1, a ragged last tile, Din != D, CONFIG and PRODUCTION,
# M = 65, widths off the 16-byte copies
DENSE_EDGE = [(1, 8, 8), (129, 16, 16), (37, 20, 36), (1000, 100, 100),
              (2000, 128, 128), (65, 128, 128), (45, 21, 37)]


@pytest.mark.parametrize("mode", ["transition", "innovation"])
@pytest.mark.parametrize("case", DENSE_EDGE, ids=[
    "M{}_D{}_Din{}".format(*c) for c in DENSE_EDGE])
def test_memory_update_3xtf32_matches_jax(case, mode):
    m, d, din = case
    rng = np.random.default_rng(m + 3 * d + 5 * din)
    args = [_draw(rng, m, din), _draw(rng, m, d, sc=0.5),
            _draw(rng, din, 3 * d, sc=din ** -0.5),
            _draw(rng, d, 3 * d, sc=d ** -0.5), _draw(rng, 3 * d, sc=0.1),
            _draw(rng, m, d, sc=0.3),
            np.round(rng.random(m) * 3).astype(np.float32), np.float32(0.37)]
    jargs = [jnp.asarray(a) for a in args]
    kw = dict(clip=1.0, delta_mode=mode)
    got = _rows(*[torch.as_tensor(a) for a in args], 1.0, mode)
    _check(got, (jax.jit(functools.partial(jref.memory_update_ref, **kw))(
                     *jargs),
                 jmu._memory_update_pallas(*jargs, interpret=True, **kw)),
           TOL["memory_update"])
