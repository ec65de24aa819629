"""The numerics of the port's `gru_cell` and `embed_attn` kernels
(`kernels/csrc/gru_cell.cu`, `kernels/csrc/embed_attn.cu`), which run
only on the card, held on the CPU.

Both kernels run their matrix products on the tensor cores, whose fp32
operands are TF32 (10 mantissa bits). Each operand x is split into
hi = tf32(x) and lo = tf32(x - hi) (the rounding of `cvt.rna.tf32.f32`:
to nearest, ties away from zero, which `tf32x3.cuh` reaches by integer
operations), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi,
each 8-deep step accumulated in fp32 (the `mma.sync` m16n8k8 steps).
`_mm3` repeats that rounding in plain PyTorch (test code: nothing on the
port's path calls it), `_gru` the cell's gate epilogue on its accumulators
(x W and h U apart, summed for r and z; x W_n and h U_n apart), and
`_embed` `embed_attn`'s fold: a_h = Wk_h q_h / sqrt(dh) per row, scores
a_h . kv_j, an online softmax over groups of four valid slots in slot
order, g_h = sum_j p_jh kv_j, out_h = g_h Wv_h.

The emulations are held against the JAX package's jitted refs and its
Pallas kernels in interpret mode on the same numpy inputs, within
`chip_smoke.py`'s `TOL` (each output within TOL * max(1, max|ref|)), at
`chip_smoke.py`'s edge shapes for both kernels and at M = 2000,
D = Din = 128. A single TF32 rounding of each operand misses
`TOL` at M = 2000, D = Din = 128: why the kernels split."""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import embed_attn as jea
from repro.kernels import gru_cell as jgru
from repro.kernels import ref as jref

from repro_torch.kernels import embed_attn as ea
from repro_torch.models import modules

TOL = {"gru_cell": 1e-5, "embed_attn": 1e-4}   # chip_smoke.TOL
SLOT_GROUP = 4      # valid slots a group in embed_attn's online softmax


def _tf32(x):
    """cvt.rna.tf32.f32's rounding, as `tf32x3.cuh::tf32_split` forms it:
    the 13 low mantissa bits rounded off, ties away from zero (on the bit
    pattern, sign and magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b, split=True, acc=None):
    """a @ b as the kernels form it: per 8-deep step, the three TF32
    products (one with split=False: tf32(a) tf32(b)) added to an fp32
    accumulator in turn, each product exact (TF32 mantissas multiply
    exactly in fp64). Leading dimensions are batch dimensions; `acc`, if
    given, is the fp32 accumulator the steps add to (else zeros)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    terms = [(a_hi, b_hi)]
    if split:
        terms = [(_tf32(a - a_hi), b_hi), (a_hi, _tf32(b - b_hi))] + terms
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = (acc.double() + x[..., k0:k0 + 8].double()
                   @ y[..., k0:k0 + 8, :].double()).float()
    return acc


def _gru(x, h, w, u, b, split=True):
    """The kernel's cell: x W and h U accumulate apart (two halves of the
    block's warps), per gate panel; r and z add the bias to x W, then
    h U (the plain version's order), then the gates in fp32."""
    d = h.shape[1]
    gx, gh = _mm3(x, w, split), _mm3(h, u, split)
    r = torch.sigmoid((gx[:, :d] + b[:d]) + gh[:, :d])
    z = torch.sigmoid((gx[:, d:2 * d] + b[d:2 * d]) + gh[:, d:2 * d])
    n = torch.tanh((gx[:, 2 * d:] + b[2 * d:]) + r * gh[:, 2 * d:])
    return (1.0 - z) * h + z * n


def _embed(h_self, tab, idx, dt, valid, tw, tb, wq, wk, wv, n_heads):
    """embed_attn's fold (see the module docstring), per head."""
    r, kk = valid.shape
    e = wq.shape[1]
    dh = e // n_heads
    q = _mm3(h_self, wq)
    kv = torch.cat([tab[idx.long()],
                    modules.time_encode({"w": tw, "b": tb}, dt)], -1)
    rank = torch.cumsum(valid.long(), 1) - 1
    group = torch.where(valid, rank // SLOT_GROUP, torch.full_like(rank, -1))
    out = torch.zeros(r, e)
    for h in range(n_heads):
        cols = slice(h * dh, (h + 1) * dh)
        a = _mm3(q[:, cols], wk[:, cols].t().contiguous()) / math.sqrt(dh)
        s = (kv * a[:, None, :]).sum(-1)
        m = torch.full((r,), -math.inf)
        l = torch.zeros(r)
        g = torch.zeros(r, kv.shape[-1])
        for gi in range(-(-kk // SLOT_GROUP)):
            sel = group == gi
            has = sel.any(1)
            mx = torch.maximum(m, torch.where(sel, s, -math.inf).amax(1))
            alpha = torch.exp(m - mx)
            p = torch.where(sel, torch.exp(s - mx[:, None]), 0.0)
            l = torch.where(has, l * alpha + p.sum(1), l)
            g = torch.where(has[:, None],
                            g * alpha[:, None] + (p[..., None] * kv).sum(1), g)
            m = torch.where(has, mx, m)
        g = torch.where((l > 0)[:, None], g / l.clamp_min(1e-30)[:, None], 0.0)
        out[:, cols] = _mm3(g, wv[:, cols].contiguous())
    return out


def _draw(rng, *shape, sc=1.0):
    return (rng.normal(size=shape) * sc).astype(np.float32)


# gru_cell: chip_smoke.py's edge shapes (M, D, Din), the row tile's edges
# (64 rows), D = 100 with Din = 172, and odd widths
GRU_EDGE = [(1, 8, 8), (37, 16, 24), (1000, 100, 100), (2000, 128, 128),
            (63, 128, 128), (65, 128, 128), (129, 100, 172), (45, 21, 37)]


def _gru_inputs(case):
    m, d, din = case
    rng = np.random.default_rng(m + 7 * d + 13 * din)
    return [_draw(rng, m, din), _draw(rng, m, d, sc=0.5),
            _draw(rng, din, 3 * d, sc=din ** -0.5),
            _draw(rng, d, 3 * d, sc=d ** -0.5), _draw(rng, 3 * d, sc=0.1)]


def _err(got, want):
    want = np.asarray(want, np.float64)
    return (float(np.abs(got.double().numpy() - want).max()),
            max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("case", GRU_EDGE,
                         ids=["M{}_D{}_Din{}".format(*c) for c in GRU_EDGE])
def test_gru_cell_3xtf32_matches_jax(case):
    args = _gru_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    got = _gru(*[torch.as_tensor(a) for a in args])
    assert got.shape == (case[0], case[1])
    for want in (jax.jit(jref.gru_cell_ref)(*jargs),
                 jgru._gru_cell_pallas(*jargs, interpret=True)):
        err, scale = _err(got, want)
        assert err <= TOL["gru_cell"] * scale, f"max|diff| {err:.3g}"


def test_gru_cell_one_tf32_rounding_misses_tol():
    """tf32(a) tf32(b) alone, at M = 2000, D = Din = 128."""
    args = _gru_inputs((2000, 128, 128))
    want = jax.jit(jref.gru_cell_ref)(*[jnp.asarray(a) for a in args])
    err, scale = _err(_gru(*[torch.as_tensor(a) for a in args], split=False),
                      want)
    assert err > TOL["gru_cell"] * scale, f"max|diff| {err:.3g}"


# embed_attn: chip_smoke.py's edge shapes (R, U, K, ds, Din, d_time, E,
# heads, all-invalid rows, dt scale, fraction of slots on one hot row):
# R = 1 with K = 1, all-invalid rows, dt to 1e5, K = 64, CONFIG (E = 100,
# 2 heads, K = 10), R not a multiple of the 32-row tile, one row shared by
# most slots
EA_EDGE = [(1, 3, 1, 8, 8, 4, 8, 1, 0, 1.0, 0.0),
           (9, 12, 3, 12, 10, 6, 12, 2, 2, 10.0, 0.0),
           (37, 50, 16, 128, 128, 64, 128, 2, 3, 1e5, 0.0),
           (3, 40, 64, 16, 16, 8, 16, 2, 1, 1e3, 0.0),
           (200, 150, 10, 100, 100, 32, 100, 2, 5, 1e5, 0.0),
           (65, 300, 16, 128, 128, 64, 128, 2, 3, 1e5, 0.0),
           (96, 500, 16, 128, 128, 64, 128, 2, 0, 1e3, 0.9)]
EA_IDS = ["R{}_U{}_K{}_ds{}_Din{}_dt{}_E{}_H{}".format(*c[:8]) + (
    "_hot" if c[10] else "") for c in EA_EDGE]


def _ea_inputs(case):
    r, u, kk, ds, din, dtime, e, heads, bad, dts, hot = case
    rng = np.random.default_rng(r + 3 * kk + 5 * e)
    valid = rng.random((r, kk)) < 0.7
    valid[:bad] = False
    idx = rng.integers(0, u, (r, kk)).astype(np.int32)
    idx[rng.random((r, kk)) < hot] = 7 % u
    return [_draw(rng, r, ds), _draw(rng, u, din), idx,
            (rng.random((r, kk)) * dts).astype(np.float32), valid,
            _draw(rng, dtime), _draw(rng, dtime),
            _draw(rng, ds, e, sc=ds ** -0.5),
            _draw(rng, din + dtime, e, sc=(din + dtime) ** -0.5),
            _draw(rng, din + dtime, e, sc=(din + dtime) ** -0.5)], heads


@pytest.mark.parametrize("case", EA_EDGE, ids=EA_IDS)
def test_embed_attn_fold_matches_jax(case):
    args, heads = _ea_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    got = _embed(*[torch.as_tensor(a) for a in args], heads)
    for want in (jax.jit(functools.partial(jref.embed_attn_ref,
                                           n_heads=heads))(*jargs),
                 jea._embed_attn_pallas(*jargs, n_heads=heads,
                                        interpret=True)):
        err, scale = _err(got, want)
        assert err <= TOL["embed_attn"] * scale, f"max|diff| {err:.3g}"
    bad = case[8]
    assert not got[:bad].any()      # a row with no valid slot is exactly 0


def test_embed_attn_limits_and_smem():
    """The launcher's shared-memory count (Layout in the source) at the
    CONFIG and PRODUCTION widths: two blocks a multiprocessor fit; the
    widest table and time encoding it takes still fit one block."""
    assert ea.smem_bytes(100, 132, 100) == 4 * (2 * 32 * 140 + 32 * 108
                                               + 3 * 32 * 72)
    assert ea.smem_bytes(128, 192, 128) == 94720
    assert 2 * (ea.smem_bytes(128, 192, 128) + 1024) <= 233472
    assert ea.smem_bytes(128, ea.MAX_DIN + ea.MAX_DTIME, ea.MAX_E) \
        <= ea.MAX_SMEM


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10            # the TF32 step above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, one + 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1.0, one, -one, 1.0, one + 2.0 ** -10])
    assert torch.equal(_tf32(x), want)
    hi = _tf32(x)
    assert torch.equal(hi + _tf32(x - hi), x)   # x has <= 21 mantissa bits
