"""The port's kernel modules against the JAX package.

On the CPU the port runs each kernel's plain PyTorch version
(`repro_torch.kernels.ref`, reached through `ops.dispatch`); it is held
against the JAX Pallas kernel in interpret mode and against the JAX jnp
oracle (jitted, as the JAX engine runs it) on the same numpy inputs, at
1e-5 absolute in fp32 (matrix products summed in another order). The CUDA
kernels themselves are held against these plain versions on the card by
`chip_smoke.py` (edge shapes, then the serve and train paths' own inputs).

The gradients of the training path's kernels (the autograd Functions of
`repro_torch.kernels.autodiff`) are held against `jax.vjp` of the JAX ref
on the same inputs and cotangents, each input at 1e-5 relative to its
largest gradient (never absolute: those reach tens)."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.kernels import embed_attn as jea
from repro.kernels import gru_cell as jgru
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
# gru_cell
# ---------------------------------------------------------------------------

# (name, M, D, Din)
GRU_CASES = [("m1", 1, 8, 8), ("ragged", 37, 16, 24), ("d100", 130, 100, 100)]


def _gru_inputs(case, seed=3):
    _, m, d, din = case
    rng = np.random.default_rng(seed)
    return [_f(rng, m, din), _f(rng, m, d, scale=0.5),
            _f(rng, din, 3 * d, scale=din ** -0.5),
            _f(rng, d, 3 * d, scale=d ** -0.5), _f(rng, 3 * d, scale=0.1)]


@pytest.mark.parametrize("case", GRU_CASES, ids=[c[0] for c in GRU_CASES])
def test_gru_cell_matches_jax(case):
    args = _gru_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    want_pl = jgru._gru_cell_pallas(*jargs, interpret=True)
    want_ref = jax.jit(jref.gru_cell_ref)(*jargs)
    got = ops.gru_cell(*[_t(a) for a in args]).numpy()
    assert got.shape == (case[1], case[2])
    np.testing.assert_allclose(got, np.asarray(want_pl), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# gradients: the autograd Functions against jax.vjp of the JAX ref
# ---------------------------------------------------------------------------


def _grad_close(got, want, name):
    want = np.asarray(want, np.float64)
    lim = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got.numpy().astype(np.float64) - want)
                .max(initial=0.0))
    assert err <= lim, f"d{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _jax_grads(fn, args, cotangents):
    """jax.vjp of `fn` at `args`, jitted as the JAX engine runs it (eager
    JAX rounds the time-encoding angle twice, jitted XLA once: ROADMAP
    Queue 3 P1)."""
    def vjp(args, cts):
        return jax.vjp(fn, *args)[1](cts)
    return jax.jit(vjp)([jnp.asarray(a) for a in args], cotangents)


def _port_grads(fn, args, diff, cotangents, clone=()):
    """Gradients of sum(out * cotangent) with respect to args[diff]; the
    inputs at `clone` enter as clones of their leaves (they are written in
    place)."""
    leaves = [_t(a) for a in args]
    for i in diff:
        leaves[i].requires_grad_(True)
    call = [x.clone() if i in clone else x for i, x in enumerate(leaves)]
    outs = fn(*call)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(list(outs), [_t(c) for c in cotangents])
    return {i: leaves[i].grad for i in diff}


@pytest.mark.parametrize("case", GRU_CASES[1:], ids=[c[0] for c in
                                                     GRU_CASES[1:]])
def test_gru_cell_grads_match_jax(case):
    args = _gru_inputs(case)
    ct = _f(np.random.default_rng(9), case[1], case[2])
    want = _jax_grads(jref.gru_cell_ref, args, jnp.asarray(ct))
    got = _port_grads(ops.gru_cell, args, range(5), [ct])
    for i, name in enumerate(("x", "h", "w", "u", "b")):
        _grad_close(got[i], want[i], name)


# float inputs of memory_update_table: the indices (3, 4) take no gradient
MU_DIFF = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11)
MU_NAMES = ("table", "last_t", "x", "gather_idx", "write_idx", "times", "w",
            "u", "b", "delta_mean", "scale", "gamma")


@pytest.mark.parametrize("case", [MU_CASES[0], MU_CASES[1], MU_CASES[4]],
                         ids=["block_edge", "masked", "din_ne_d"])
def test_memory_update_table_grads_match_jax(case):
    """Cotangents on every output, the written table rows included: the
    gradient of W and U then needs the rows as they were BEFORE the
    in-place write, and of `fused` the written rows' cotangent."""
    args = _mu_inputs(case)
    kw = dict(clip=1.0, delta_mode="transition")
    m, n, d = case[1], case[2], case[3]
    rng = np.random.default_rng(11)
    cts = [_f(rng, n, d), _f(rng, n), _f(rng, m, d), _f(rng, m, d),
           _f(rng, m, d)]
    want = _jax_grads(functools.partial(jref.memory_update_table_ref, **kw),
                      args, tuple(jnp.asarray(c) for c in cts))
    got = _port_grads(functools.partial(ops.memory_update_table, **kw), args,
                      MU_DIFF, cts, clone=(0, 1))
    for i in MU_DIFF:
        _grad_close(got[i], want[i], MU_NAMES[i])


@pytest.mark.parametrize("case", EA_CASES[1:], ids=[c[0] for c in
                                                    EA_CASES[1:]])
def test_embed_attn_grads_match_jax(case):
    args, heads, _ = _ea_inputs(case)
    ct = _f(np.random.default_rng(12), args[0].shape[0], args[7].shape[1])
    diff = (0, 1, 3, 5, 6, 7, 8, 9)             # idx (2), valid (4): none
    want = _jax_grads(functools.partial(jref.embed_attn_ref, n_heads=heads),
                      args, jnp.asarray(ct))
    got = _port_grads(functools.partial(ops.embed_attn, n_heads=heads), args,
                      diff, [ct])
    for i in diff:
        _grad_close(got[i], want[i], f"arg{i}")


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

