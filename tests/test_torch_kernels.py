"""The port's kernel modules against the JAX package.

On the CPU the port runs each kernel's plain PyTorch version
(`repro_torch.kernels.ref`, reached through `ops.dispatch`); it is held
against the JAX Pallas kernel in interpret mode and against the JAX jnp
oracle (jitted, as the JAX engine runs it) on the same numpy inputs, at
1e-5 absolute in fp32 (matrix products summed in another order). The CUDA
kernels themselves are held against these plain versions on the card by
`chip_smoke.py` (edge shapes, then the serve path's own inputs)."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import embed_attn as jea
from repro.kernels import link_score as jls
from repro.kernels import memory_update as jmu
from repro.kernels import ref as jref
from repro.models import mdgnn as jmdgnn

from repro_torch.kernels import ops

TOL = 1e-5


def _f(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, device="cpu"):
    return torch.as_tensor(np.array(a), device=device)


# ---------------------------------------------------------------------------
# memory_update_table
# ---------------------------------------------------------------------------

# (name, M, N, D, Din, masked fraction, occurrences of one hot node)
MU_CASES = [
    ("block_edge", 200, 50, 16, 24, 0.0, 70),
    ("masked", 24, 10, 8, 8, 0.4, 0),
    ("m1", 1, 5, 8, 8, 0.0, 0),
    ("d100", 12, 30, 100, 100, 0.2, 3),
    ("din_ne_d", 16, 9, 12, 20, 0.1, 5),
]


def _mu_inputs(case, seed=0):
    _, m, n, d, din, mfrac, hot = case
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, n, m).astype(np.int32)
    if hot:
        nodes[rng.choice(m, hot, replace=False)] = 7 % n
    times = np.round(rng.random(m) * 5).astype(np.float32)   # with ties
    mask = rng.random(m) >= mfrac
    # the occurrence layout the fused path hands the kernel
    order = np.asarray(jmdgnn.occurrence_order(nodes, times, mask))
    sel = np.asarray(jmdgnn._last_occurrence_flags(nodes, times, mask))
    gidx = np.where(mask, nodes, n + 1)[order].astype(np.int32)
    widx = np.where(sel, nodes, n)[order].astype(np.int32)
    args = [_f(rng, n, d, scale=0.5), _f(rng, n), _f(rng, m, din), gidx, widx,
            times[order], _f(rng, din, 3 * d, scale=din ** -0.5),
            _f(rng, d, 3 * d, scale=d ** -0.5), _f(rng, 3 * d, scale=0.1),
            _f(rng, m, d, scale=0.3),
            np.maximum(np.round(rng.random(m) * 3), 0).astype(np.float32),
            np.float32(0.37)]
    return args


@pytest.mark.parametrize("delta_mode", ["transition", "innovation"])
@pytest.mark.parametrize("case", MU_CASES, ids=[c[0] for c in MU_CASES])
def test_memory_update_table_matches_jax(case, delta_mode):
    args = _mu_inputs(case)
    kw = dict(clip=1.0, delta_mode=delta_mode)
    want_pl = jmu._memory_update_table_pallas(
        *[jnp.asarray(a) for a in args], interpret=True, **kw)
    want_ref = jax.jit(functools.partial(jref.memory_update_table_ref, **kw))(
        *[jnp.asarray(a) for a in args])
    targs = [_t(a) for a in args]
    table0 = targs[0].clone()
    got = ops.memory_update_table(*targs, **kw)
    assert got[0].data_ptr() == targs[0].data_ptr()      # in place
    assert not torch.equal(got[0], table0) or case[0] == "masked"
    for g, wp, wr in zip(got, want_pl, want_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), atol=TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# embed_attn
# ---------------------------------------------------------------------------

# (name, R, U, K, Din_self, Din, d_time, E, heads, all-invalid rows, dt scale)
EA_CASES = [
    ("r1k1", 1, 3, 1, 8, 8, 4, 8, 1, 0, 1.0),
    ("heads2_invalid", 9, 12, 3, 12, 10, 6, 12, 2, 2, 10.0),
    ("d100_wide_dt", 16, 20, 4, 100, 100, 32, 100, 2, 1, 1e4),
]


def _ea_inputs(case, seed=1):
    _, r, u, kk, ds, din, dtime, e, heads, n_bad, dts = case
    rng = np.random.default_rng(seed)
    valid = rng.random((r, kk)) < 0.7
    valid[:n_bad] = False
    args = [_f(rng, r, ds), _f(rng, u, din),
            rng.integers(0, u, (r, kk)).astype(np.int32),
            (rng.random((r, kk)) * dts).astype(np.float32), valid,
            _f(rng, dtime), _f(rng, dtime), _f(rng, ds, e, scale=ds ** -0.5),
            _f(rng, din + dtime, e, scale=(din + dtime) ** -0.5),
            _f(rng, din + dtime, e, scale=(din + dtime) ** -0.5)]
    return args, heads, n_bad


@pytest.mark.parametrize("case", EA_CASES, ids=[c[0] for c in EA_CASES])
def test_embed_attn_matches_jax(case):
    args, heads, n_bad = _ea_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    want_pl = jea._embed_attn_pallas(*jargs, n_heads=heads, interpret=True)
    want_ref = jax.jit(functools.partial(jref.embed_attn_ref,
                                         n_heads=heads))(*jargs)
    got = ops.embed_attn(*[_t(a) for a in args], n_heads=heads).numpy()
    np.testing.assert_allclose(got, np.asarray(want_pl), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL, rtol=0)
    assert (got[:n_bad] == 0).all()            # all-invalid rows are exactly 0


# ---------------------------------------------------------------------------
# link_score
# ---------------------------------------------------------------------------

LS_CASES = [("b1", 1, 37, 16), ("ragged", 5, 130, 100)]


def _ls_inputs(case, seed=2):
    _, b, i, d = case
    rng = np.random.default_rng(seed)
    return [_f(rng, b, d), _f(rng, i, d), _f(rng, 2 * d, d, scale=d ** -0.5),
            _f(rng, d, scale=0.1), _f(rng, d, 1, scale=d ** -0.5),
            _f(rng, 1)]


@pytest.mark.parametrize("case", LS_CASES, ids=[c[0] for c in LS_CASES])
def test_link_score_matches_jax(case):
    args = _ls_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    want_pl = jls._link_score_pallas(*jargs, interpret=True)
    want_ref = jax.jit(jref.link_score_ref)(*jargs)
    got = ops.link_score(*[_t(a) for a in args]).numpy()
    assert got.shape == (case[1], case[2])
    np.testing.assert_allclose(got, np.asarray(want_pl), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# dispatch policy
# ---------------------------------------------------------------------------


def test_dispatch_policy_on_cpu():
    args = [_t(a) for a in _ls_inputs(LS_CASES[0])]
    ops.reset_launch_counts()
    auto = ops.link_score(*args)
    torch.testing.assert_close(ops.link_score(*args, mode="oracle"), auto,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.link_score(*args, mode="compiled")
    with pytest.raises(NotImplementedError, match="interpret"):
        ops.link_score(*args, mode="interpret")
    with pytest.raises(ValueError, match="unknown"):
        ops.link_score(*args, mode="fast")
    assert ops.launch_counts() == {k: 0 for k in ops.REGISTRY}

