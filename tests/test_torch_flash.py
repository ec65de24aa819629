"""The numerics of the port's bf16 `flash_attn` kernel (`kernels/csrc/
flash_attn_wgmma.cu`), which runs only on the card, held on the CPU, and
its dtype routing.

The kernel forms q kᵀ from bf16 inputs with fp32 accumulation, runs the
online softmax over 64-key tiles in fp32, splits each probability p into
p_hi = bf16(p) and p_lo = bf16(p - p_hi) and adds both products with V
into one fp32 accumulator. `_emulate` repeats that rounding in plain
PyTorch (test code: nothing on the port's path calls it). On the bf16
edge shapes of `chip_smoke.py` (all but its S = 8,192 one, too large for
this CPU) the emulation stays within `ref.bf16_excess <= 0` of the fp32
plain version, the one-ulp check `chip_smoke.py` holds the kernel to;
with P rounded to bf16 once (what SDPA does) it does not. The fp32 plain
version is held against JAX's `flash_attn_ref` on the same numpy inputs
within 1e-5 of the output's scale (sums in another order)."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attn as jfa

from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops, ref

TOL = 1e-5          # chip_smoke.TOL["flash_attn"]
BN = 64             # keys per tile, as the kernel's

# (G, Gkv, S, T, D, causal, window): chip_smoke.py's flash_attn edge shapes
EDGE = [(1, 1, 1, 1, 64, True, None), (4, 2, 1, 37, 128, False, None),
        (2, 2, 100, 100, 64, True, None), (8, 2, 130, 130, 128, True, 50),
        (4, 1, 64, 200, 64, True, None), (4, 4, 200, 64, 40, True, None),
        (2, 1, 200, 50, 64, True, 10), (6, 3, 257, 257, 256, False, 70),
        (32, 16, 300, 300, 128, True, None),
        (3, 3, 129, 65, 16, False, None), (4, 2, 190, 190, 96, True, None),
        (2, 2, 100, 77, 80, False, 30), (6, 2, 150, 150, 128, True, None),
        (3, 1, 70, 70, 20, True, None)]
IDS = ["G{}_Gkv{}_S{}_T{}_D{}_c{}_w{}".format(*c) for c in EDGE]


def _inputs(case):
    """q and k at 0.5, v at 1 (as chip_smoke.py draws them), as bf16."""
    g, gkv, s, t, d = case[:5]
    rng = np.random.default_rng(7 * g + 11 * s + 13 * t + d)
    draw = lambda *shape, sc=1.0: (rng.normal(size=shape) * sc).astype(
        np.float32)
    return (draw(g, s, d, sc=0.5), draw(gkv, t, d, sc=0.5),
            draw(gkv, t, d))


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16)


def _emulate(q, k, v, causal, window, split=True):
    """The kernel's rounding: bf16 q, k, v; scores in fp32 times the fp32
    1 / sqrt(D); per 64-key tile the running max from -1e30, alpha =
    exp(m_old - m_new), l = alpha l + sum p, acc = alpha acc + p_hi V
    (+ p_lo V when split); out = acc / max(l, 1e-30) in bf16. Masked
    scores are -1e30, as the kernel's (it skips whole masked tiles, which
    weigh exactly 0 here once a row has a valid key)."""
    g, s, d = q.shape
    gkv, t = k.shape[:2]
    q = q.float()
    k = k.float().repeat_interleave(g // gkv, 0)
    v = v.float().repeat_interleave(g // gkv, 0)
    scale = (torch.tensor(1.0) / torch.tensor(math.sqrt(d))).float()
    m = torch.full((g, s, 1), -1e30)
    l = torch.zeros((g, s, 1))
    acc = torch.zeros((g, s, d))
    q_pos = torch.arange(s)[:, None]
    for k0 in range(0, t, BN):
        k_pos = torch.arange(k0, min(k0 + BN, t))[None, :]
        sc = (q @ k[:, k0:k0 + BN].transpose(1, 2)) * scale
        ok = torch.ones((s, k_pos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= k_pos <= q_pos
        if window is not None:
            ok &= k_pos > q_pos - window
        sc = torch.where(ok, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        vt = v[:, k0:k0 + BN]
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("case", EDGE, ids=IDS)
def test_split_p_within_one_bf16_ulp(case):
    causal, window = case[5:]
    q, k, v = (_bf16(a) for a in _inputs(case))
    want32 = ref.flash_attn_ref(q.float(), k.float(), v.float(),
                                causal=causal, window=window)
    excess, err = ref.bf16_excess(_emulate(q, k, v, causal, window), want32,
                                  TOL)
    assert excess <= 0, (f"split P: {excess:.3g} beyond one bf16 ulp "
                         f"(max|diff| {err:.3g})")


@pytest.mark.parametrize("case", EDGE[1:], ids=IDS[1:])
def test_bf16_p_misses_one_ulp(case):
    """P rounded to bf16 once fails the same check: why the kernel splits
    it (S = T = 1 is exact either way and is left out)."""
    causal, window = case[5:]
    q, k, v = (_bf16(a) for a in _inputs(case))
    want32 = ref.flash_attn_ref(q.float(), k.float(), v.float(),
                                causal=causal, window=window)
    excess, _ = ref.bf16_excess(
        _emulate(q, k, v, causal, window, split=False), want32, TOL)
    assert excess > 0


@pytest.mark.parametrize("case", EDGE, ids=IDS)
def test_flash_attn_ref_matches_jax(case):
    causal, window = case[5:]
    q, k, v = _inputs(case)
    got = ref.flash_attn_ref(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), causal=causal,
                             window=window)
    want = np.asarray(jfa.flash_attn_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         window=window), np.float64)
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.double().numpy() - want).max())
    assert err <= lim, f"max|port - jax| = {err:.3g} > {lim:.3g}"


def test_bf16_excess():
    """One bf16 ulp of each reference value (8 significant bits) plus
    TOL * max(1, max|ref|) is allowed; two ulps are not."""
    want = torch.tensor([1.0, -3.0, 1e-3, 200.0])
    ulp = torch.tensor([2.0 ** -7, 2.0 ** -6, 2.0 ** -17, 1.0])
    slack = TOL * 200.0
    excess, err = ref.bf16_excess(want, want, TOL)
    assert excess == pytest.approx(-2.0 ** -17 - slack) and err == 0.0
    excess, err = ref.bf16_excess(want + ulp, want, TOL)
    assert excess == pytest.approx(-slack, abs=1e-9) and err == 1.0
    excess, err = ref.bf16_excess(want + 2 * ulp, want, TOL)
    assert excess == pytest.approx(1.0 - slack) and err == 2.0


def test_routes_on_the_cpu():
    """A CPU tensor takes the plain version in either dtype and launches
    nothing; the kernel wrapper refuses CPU tensors; reset_launch_counts
    clears the count by route."""
    assert fa.ROUTES == {torch.float32: "fma", torch.bfloat16: "wgmma"}
    q, k, v = (_bf16(a) for a in _inputs(EDGE[3]))
    fa.launches_by_route["wgmma"] = 5
    ops.reset_launch_counts()
    assert fa.launches_by_route == {"fma": 0, "wgmma": 0}
    got = ops.flash_attn(q, k, v, causal=True, window=50)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got, ref.flash_attn_ref(q, k, v, causal=True, window=50),
        rtol=0, atol=0)
    assert ops.launch_counts()["flash_attn"] == 0
    assert fa.launches_by_route == {"fma": 0, "wgmma": 0}
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attn_cuda(q, k, v)


def test_tma_ready_pads_and_aligns():
    """The wgmma route's inputs: D zero-padded to a multiple of 8 (TMA's
    16-byte row stride), a misaligned start copied."""
    x = torch.randn(2, 5, 20).to(torch.bfloat16)
    padded = fa._tma_ready(x, 24)
    assert padded.shape == (2, 5, 24)
    assert torch.equal(padded[..., :20], x)
    assert not padded[..., 20:].any()
    base = torch.randn(1 + 2 * 5 * 24).to(torch.bfloat16)
    view = base[1:].view(2, 5, 24)
    assert view.data_ptr() % 16
    moved = fa._tma_ready(view, 24)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)
    assert fa._tma_ready(padded, 24) is padded
