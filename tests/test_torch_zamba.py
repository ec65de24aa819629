"""The port's zamba2 (the `hybrid` family) against the JAX package: the
Mamba2 block (`_causal_conv`, `mamba2` through `chunked_linear_rnn`,
`mamba2_decode` from `mamba2_decode_init`) and the reduced zamba2-1.2b,
forward, last-position prefill and decode, in both parameter layouts.

The same numpy inputs go through JAX (jitted, as its engine runs it) and
the port on the CPU, where each `ssd_chunk` launch is the kernel's plain
version (`chip_smoke.py` holds the CUDA kernel against it on the card).
JAX's parameters are carried over by `bridge.zoo_params_from_numpy`.
Outputs agree within TOL * max(1, max|JAX|), TOL = 1e-5: float32 sums in
another order (the chunk's products and the unembedding), except the
Mamba2 block over two chunks with drawn decays (TOL_SSM, below)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.configs import get_config as jget_config
from repro.nn import ssm as jssm
from repro.nn.module import ParamBuilder as JParamBuilder

from repro_torch import bridge
from repro_torch.archs import api
from repro_torch.configs import get_config
from repro_torch.nn import ssm

TOL = 1e-5
# Mamba2's log decays, -exp(A_log) * dt (here -0.6 to -2.3 a step on
# average), sum to a cumulative log decay of -150 to -600 over a chunk of
# 256. float32 rounds that sum to about |lcum| * 2^-24 (up to 3.5e-5),
# and each decay factor exp(lcum_i - lcum_j) carries it as a relative
# error. Both packages are that far from a float64 recurrence, in
# different directions (measured on these inputs: the port 1.2e-4, JAX
# 1.9e-4, of a largest |y| of 36), so the two are held to 1e-4.
TOL_SSM = 1e-4
D_MODEL, D_STATE, HEAD = 64, 16, 32


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _mamba_params(seed=0):
    """JAX's Mamba2 parameters at d = 64, state 16, head 32 (4 heads),
    with A_log, dt_bias, D, conv_b and norm_scale drawn too (JAX inits
    them to constants). The log decay, -exp(A_log) * dt, is then about
    -0.3 to -4 a step, so the cumulative log decay reaches about -10^3
    over a chunk of 256; its rounding, about |lcum| * 2^-24 in each
    decay factor, is what separates the two packages' outputs."""
    b = JParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jssm.mamba2_init(b, "cell", D_MODEL, D_STATE, head_dim=HEAD)
    p = jax.tree.map(np.asarray, b.params["cell"])
    rng = np.random.default_rng(seed)
    h = p["A_log"].shape[0]
    p["A_log"] = rng.normal(size=h).astype(np.float32) * 0.5
    p["dt_bias"] = rng.normal(size=h).astype(np.float32)
    p["D"] = rng.normal(size=h).astype(np.float32)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32) * 0.1
    p["norm_scale"] = (1 + 0.1 * rng.normal(size=p["norm_scale"].shape)
                       ).astype(np.float32)
    return p


def test_softplus_matches_jax():
    """jax.nn.softplus (logaddexp(x, 0)) also past F.softplus's threshold
    of 20, where that returns x itself."""
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    _close(ssm._softplus(_t(x)), jax.jit(jax.nn.softplus)(x), "softplus")


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    want = jax.jit(jssm._causal_conv)(x, w, b)
    _close(ssm._causal_conv(_t(x), _t(w), _t(b)), want, "_causal_conv")


def test_mamba2_matches_jax():
    """S = 300 in chunks of 256: two chunks, the second padded, from a
    non-zero initial state; the output and the final state."""
    p = _mamba_params()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 300, D_MODEL)).astype(np.float32)
    h0 = (rng.normal(size=(2, 4, D_STATE, HEAD)) * 0.3).astype(np.float32)
    jy, jst = jax.jit(lambda prm, a, s0: jssm.mamba2(
        prm, a, d_state=D_STATE, head_dim=HEAD, init_state=s0,
        return_state=True))(p, x, h0)
    pt = bridge.zoo_params_from_numpy(p, "cpu")
    y, st = ssm.mamba2(pt, _t(x), d_state=D_STATE, head_dim=HEAD,
                       init_state=_t(h0), return_state=True)
    _close(y, jy, "mamba2 y", TOL_SSM)
    _close(st, jst, "mamba2 final state", TOL_SSM)


def test_mamba2_decode_matches_jax():
    """4 steps from mamba2_decode_init: each step's output and both
    states; the steps also equal the port's own full-sequence block."""
    p = _mamba_params(3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, D_MODEL)).astype(np.float32)
    pt = bridge.zoo_params_from_numpy(p, "cpu")
    jstate = jssm.mamba2_decode_init(2, p, D_STATE, HEAD)
    state = ssm.mamba2_decode_init(2, pt, D_STATE, HEAD)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in jstate.items()}
    jstep = jax.jit(lambda prm, a, st: jssm.mamba2_decode(
        prm, a, st, d_state=D_STATE, head_dim=HEAD))
    full = ssm.mamba2(pt, _t(x), d_state=D_STATE, head_dim=HEAD)
    for i in range(4):
        jy, jstate = jstep(p, x[:, i:i + 1], jstate)
        y, state = ssm.mamba2_decode(pt, _t(x[:, i:i + 1]), state,
                                     d_state=D_STATE, head_dim=HEAD)
        _close(y, jy, f"decode step {i}")
        for name in ("ssm", "conv"):
            _close(state[name], jstate[name], f"step {i} {name} state")
        _close(y[:, 0], full[:, i].numpy(), f"decode step {i} vs mamba2",
               tol=1e-4)


# (layout, n_layers): the reduced config's one unit (attn_every 2), and
# three layers for one unit and a tail block
ZAMBA = [(False, 2), (True, 2), (False, 3), (True, 3)]


@pytest.mark.parametrize("scan,n_layers", ZAMBA,
                         ids=[f"{'stacked' if s else 'units'}-{n}layers"
                              for s, n in ZAMBA])
def test_reduced_zamba_matches_jax(scan, n_layers):
    """The reduced zamba2-1.2b at attn_chunk=32 and S = 64, so the shared
    block takes the blockwise branch (flash_attn); forward, the
    last-position prefill, and 4 decode steps against JAX's jitted ones
    (and against the port's own forward at each position)."""
    kw = dict(scan_layers=scan, attn_chunk=32, n_layers=n_layers)
    jcfg = jget_config("zamba2-1.2b").reduced(**kw)
    jmodel = japi.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                         jcfg.vocab), np.int32)
    want = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})

    cfg = get_config("zamba2-1.2b").reduced(**kw)
    model = api.get_model(cfg)
    params = bridge.zoo_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          "cpu")
    with torch.no_grad():
        got = model.forward(params, {"tokens": _t(toks)})
        last = model.prefill(params, {"tokens": _t(toks)})
    _close(got, want, "forward")
    _close(last, np.asarray(want)[:, -1], "prefill vs JAX forward[:, -1]")
    _close(last, got[:, -1].numpy(), "prefill vs forward[:, -1]")

    jstate = jmodel.init_decode_state(2, 16)
    jstep = jax.jit(jmodel.decode_step)
    with torch.no_grad():
        state = model.init_decode_state(2, 16, "cpu")
        for i in range(4):
            tok = toks[:, i:i + 1]
            jl, jstate = jstep(jparams, jstate, jnp.asarray(tok),
                               jnp.asarray(i, jnp.int32))
            lg, state = model.decode_step(params, state, _t(tok), i)
            _close(lg, jl, f"decode step {i}")
            err = float((lg[:, 0] - got[:, i]).abs().max())
            assert err < 1e-4, (i, err)


def test_port_zamba_init_matches_jax_tree():
    """The port's own init builds JAX's tree (keys and shapes) with a
    tail block, in both layouts."""
    for scan in (False, True):
        kw = dict(scan_layers=scan, n_layers=3)
        jp = jax.eval_shape(lambda k: japi.get_model(
            jget_config("zamba2-1.2b").reduced(**kw)).init(k)[0],
            jax.random.PRNGKey(0))
        pt = api.get_model(get_config("zamba2-1.2b").reduced(**kw)).init(
            torch.Generator().manual_seed(0), "cpu")
        want = {"/".join(str(k.key) for k in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_leaves_with_path(jp)}
        got = {"/".join(str(k.key) for k in path): tuple(x.shape)
               for path, x in jax.tree_util.tree_leaves_with_path(
                   jax.tree.map(lambda t: t.numpy(), pt))}
        assert got == want, scan
