"""The numerics of the port's `link_score` kernel
(`kernels/csrc/link_score.cu`), which runs only on the card, held on the
CPU.

The kernel forms both factors, A = h_src @ W1[:D] and C = h_items @ W1[D:],
on the tensor cores at fp32 grade, transposed (W1's columns are the mma's
rows): each operand split into hi = tf32(x) and lo = tf32(x - hi), three
TF32 products a step in the order W_lo x_hi, W_hi x_lo, W_hi x_hi, each
8-deep step accumulated in fp32 (`_mm3` of `test_torch_gru_embed.py`, with
W1's slice as its first operand). b1 is added to A once (the plain version
adds it after A + C). The pair pass runs over passes of 128 columns; each
pass's columns, rounded up to 16, fall into four quarters, and each
quarter's sum runs d in order as fmaf(max(A_b1 + C, 0), w2, acc). A pass's
four sums are added in quarter order, the passes' totals in pass order,
then b2.
`_link` repeats that order in plain PyTorch (test code: nothing on the
port's path calls it).

The emulation is held against the JAX package's Pallas kernel in
interpret mode and its jitted ref on the same numpy inputs, within
`chip_smoke.py`'s `TOL` (each output within TOL * max(1, max|ref|)), at
`chip_smoke.py`'s edge shapes and at serving's top-k shape (B = 16,
I = 20,000, D = 128); B = 1,024 there runs the JAX side in slices of
sources, whose scores do not depend on the other sources, so no (B, I, D)
tensor of 10 GB is formed. `PYTHONPATH=src python
tests/test_torch_link_score.py` prints the error a single TF32 rounding
of each operand gives at the top-k shape."""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.kernels import link_score as jls
from repro.kernels import ref as jref

from test_torch_gru_embed import _err, _mm3

ROOT = pathlib.Path(__file__).resolve().parents[1]
COLS = 128          # link_score.cu: factor columns a pass
QUARTERS = 4        # pair threads a pair: a quarter of a pass's columns
SLICE = 64          # sources a JAX call at B = 1,024


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TOL = CS.TOL["link_score"]


def _fma(a, w, acc):
    """fmaf: the product exact in float64, the sum rounded to fp32."""
    return (a.double() * w + acc.double()).float()


def _link(hs, hi, w1, b1, w2, b2, split=True):
    """link_score.cu's arithmetic (see the module docstring)."""
    d = hs.shape[1]
    tot = torch.zeros(hs.shape[0], hi.shape[0])
    for n0 in range(0, d, COLS):
        acc = [torch.zeros_like(tot) for _ in range(QUARTERS)]
        pw = min(COLS, d - n0)
        cols = slice(n0, n0 + pw)
        a = _mm3(w1[:d, cols].t().contiguous(), hs.t().contiguous(),
                 split).t() + b1[cols]
        c = _mm3(w1[d:, cols].t().contiguous(), hi.t().contiguous(),
                 split).t()
        fq = (pw + 15) // 16 * 4      # columns a quarter
        for q in range(QUARTERS):
            for j in range(q * fq, min((q + 1) * fq, pw)):
                h = torch.relu(a[:, None, j] + c[None, :, j])
                acc[q] = _fma(h, float(w2[n0 + j, 0]), acc[q])
        tot = tot + (((acc[0] + acc[1]) + acc[2]) + acc[3])
    return tot + b2[0]


def _draw(rng, *shape, sc=1.0):
    return (rng.normal(size=shape) * sc).astype(np.float32)


# chip_smoke.py's edge shapes (B, I, D, h_items a view of h[B:]) and
# serving's top-k shape
EDGE = [(1, 37, 16, False), (5, 130, 100, False), (33, 20000, 128, False),
        (5, 130, 21, False), (1, 37, 21, True), (16, 79, 128, False),
        (16, 81, 128, False), (16, 19999, 128, False),
        (16, 20001, 21, False), (16, 10560, 128, False),
        (16, 10561, 128, False), (17, 20000, 128, False),
        (1024, 20000, 128, False), (16, 300, 172, False),
        (8, 20001, 172, False), (16, 20000, 128, False)]
IDS = ["B{}_I{}_D{}".format(*c[:3]) + ("_view" if c[3] else "")
       for c in EDGE]


def _inputs(case):
    b, i, d, view = case
    rng = np.random.default_rng(b + 3 * i + 7 * d)
    if view:
        h = _draw(rng, b + i, d)
        hs, hi = h[:b], h[b:]
    else:
        hs, hi = _draw(rng, b, d), _draw(rng, i, d)
    return [hs, hi, _draw(rng, 2 * d, d, sc=d ** -0.5),
            _draw(rng, d, sc=0.1), _draw(rng, d, 1, sc=d ** -0.5),
            _draw(rng, 1)]


def _jax(fn, args):
    """fn over slices of SLICE sources (one call where B <= SLICE)."""
    hs, rest = args[0], [jnp.asarray(a) for a in args[1:]]
    return np.concatenate([np.asarray(fn(jnp.asarray(hs[s:s + SLICE]),
                                         *rest))
                           for s in range(0, hs.shape[0], SLICE)])


@pytest.mark.parametrize("case", EDGE, ids=IDS)
def test_link_score_3xtf32_matches_jax(case):
    args = _inputs(case)
    got = _link(*[torch.as_tensor(a) for a in args])
    assert got.shape == (case[0], case[1])
    for fn in (jax.jit(jref.link_score_ref),
               lambda *a: jls._link_score_pallas(*a, interpret=True)):
        err, scale = _err(got, _jax(fn, args))
        assert err <= TOL * scale, f"max|diff| {err:.3g}"


def test_link_score_work_splits_tf32_and_fp32():
    """The factors as three TF32 products at the TF32 peak, the pair pass
    (5 operations a pair-depth element) at the fp32 peak; the old count,
    all at the fp32 peak, kept by `fp32_flops`."""
    nb, ni, d = 16, 20000, 128
    args = [torch.zeros(nb, d), torch.zeros(ni, d), torch.zeros(2 * d, d),
            torch.zeros(d), torch.zeros(d, 1), torch.zeros(1)]
    nbytes, flops = CS.work("link_score", args)
    assert flops == {CS.PEAK_TF32: 3 * 2 * (nb + ni) * d * d,
                     CS.PEAK_FP32: 5 * nb * ni * d}
    assert nbytes == ((nb + ni) * d + 2 * d * d + 2 * d + 1 + nb * ni) * 4
    assert CS.fp32_flops("link_score", args) == \
        2 * (nb + ni) * d * d + 5 * nb * ni * d
    ms, by = CS.bound("link_score", args)
    assert by == "operations"
    assert ms == pytest.approx(0.003975, rel=1e-3)


def main():
    """The error of a single TF32 rounding of each factor operand at the
    top-k shape, against the jitted JAX ref (not a test: a record)."""
    args = _inputs((16, 20000, 128, False))
    want = np.asarray(jax.jit(jref.link_score_ref)(
        *[jnp.asarray(a) for a in args]))
    for split in (True, False):
        err, scale = _err(_link(*[torch.as_tensor(a) for a in args],
                                split=split), want)
        print(f"{'3xTF32' if split else 'one TF32 rounding'}: max|diff| "
              f"{err:.3g}, TOL x scale {TOL * scale:.3g}")


if __name__ == "__main__":
    main()
