"""The port's unfused PRES route (the rnn memory cell through
`pres_filter`), the dense `memory_update` op, the paper's "time" scale and
the mean aggregator against the JAX package on the CPU.

Kernel modules: the port runs each kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode and its jnp oracle
jitted, on the same numpy inputs. Paths: both sides start from the same
parameters and state (JAX's, moved through `repro_torch.bridge`) and score
the same negatives (JAX's draws, injected); the JAX step runs with
use_kernels=True, which on the CPU resolves every kernel to its jitted
oracle.

Tolerances: `pres_filter` 1e-6 * max(1, |ref|) element by element (a few
roundings an element; jitted XLA may contract a product and a sum into one
rounding, the port rounds each); `memory_update` 1e-5 of each output's
scale (matrix products summed in another order); gradients 1e-5 of each
input's largest gradient, against jitted `jax.vjp`; train steps as
tests/test_torch_train.py holds the GRU route (loss 1e-5 relative, logits
1e-4, table and parameters 1e-5 after one step and 1e-4 after three,
last_update and rings exact, trackers 1e-4); epoch and validation AP 1e-3;
serving as tests/test_torch_serve.py."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.graph.negatives import sample_negatives as jsample
from repro.kernels import memory_update as jmu
from repro.kernels import pres_filter as jpf
from repro.kernels import ref as jref
from repro.models import mdgnn as jmdgnn
from repro.models import modules as jmodules
from repro.optim import optimizers as joptim
from repro.serve import MicroBatcher as JBatcher
from repro.serve import ServeEngine as JEngine
from repro.train import loop as jloop
from repro.train import pipeline as jpipeline

from repro_torch import bridge
from repro_torch.graph import events as tevents
from repro_torch.kernels import ops
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.models import modules as tmodules
from repro_torch.optim import optimizers as toptim
from repro_torch.serve import MicroBatcher, ServeEngine
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline

B = 100            # temporal batch size on the 600-event tiny stream


def _f(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol, what, floor=1.0):
    """|got - want| <= tol * max(floor, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol * max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _close_elementwise(got, want, tol, what):
    """|got - want| <= tol * max(1, |want|) for every element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) - tol * np.maximum(1.0, np.abs(want))
    assert excess.max(initial=-1.0) <= 0.0, \
        f"{what}: max |port - jax| = {np.abs(got - want).max():.3g}"


def _jax_grads(fn, args, cotangents):
    """jax.vjp of `fn` (whose outputs are a tuple) at `args`, jitted as the
    JAX engine runs it."""
    def vjp(args, cts):
        return jax.vjp(fn, *args)[1](cts)
    return jax.jit(vjp)([jnp.asarray(a) for a in args],
                        tuple(jnp.asarray(c) for c in cotangents))


def _port_grads(fn, args, diff, cotangents):
    """Gradients of sum(out * cotangent) with respect to args[diff]."""
    leaves = [_t(a) for a in args]
    for i in diff:
        leaves[i].requires_grad_(True)
    outs = fn(*leaves)
    torch.autograd.backward(list(outs), [_t(c) for c in cotangents])
    return {i: leaves[i].grad for i in diff}


# ---------------------------------------------------------------------------
# pres_filter
# ---------------------------------------------------------------------------

# (name, M, D, delta_mean scale): "clip" drives scale * delta_mean past both
# bounds and onto them exactly
PF_CASES = [("m1", 1, 8, 0.3), ("ragged", 37, 12, 0.3), ("d7", 50, 7, 0.3),
            ("clip", 64, 16, 2.0)]
PF_CLIP = 1.0


def _pf_inputs(case, seed=31):
    _, m, d, dscale = case
    rng = np.random.default_rng(seed)
    dt = np.round(rng.random(m) * 4).astype(np.float32)    # counts, 0 too
    dmean = _f(rng, m, d, scale=dscale)
    if case[0] == "clip":
        dt[:4] = 2.0
        dmean[0, :4] = [0.5, -0.5, 0.5, -0.5]               # on the bounds
    return [_f(rng, m, d, scale=0.5), _f(rng, m, d, scale=0.5), dmean, dt,
            np.float32(0.37)]


@pytest.mark.parametrize("delta_mode", ["transition", "innovation"])
@pytest.mark.parametrize("case", PF_CASES, ids=[c[0] for c in PF_CASES])
def test_pres_filter_matches_jax(case, delta_mode):
    args = _pf_inputs(case)
    kw = dict(clip=PF_CLIP, delta_mode=delta_mode)
    got = ops.pres_filter(*[_t(a) for a in args], **kw)
    assert ops.launch_counts()["pres_filter"] == 0     # the plain version
    pallas = jpf.pres_filter(*[jnp.asarray(a) for a in args], interpret=True,
                             **kw)
    oracle = jax.jit(functools.partial(jref.pres_filter_ref, **kw))(*args)
    for name, g, p, o in zip(("fused", "delta"), got, pallas, oracle):
        _close_elementwise(g.numpy(), p, 1e-6, f"{name} vs Pallas")
        _close_elementwise(g.numpy(), o, 1e-6, f"{name} vs oracle")
    if case[0] == "clip":
        step = np.asarray(args[3])[:, None] * np.asarray(args[2])
        assert (step > PF_CLIP).any() and (step < -PF_CLIP).any()


@pytest.mark.parametrize("delta_mode", ["transition", "innovation"])
@pytest.mark.parametrize("case", PF_CASES[1:], ids=[c[0] for c in
                                                    PF_CASES[1:]])
def test_pres_filter_grads_match_jax(case, delta_mode):
    """Gradients of s_prev, s_meas, delta_mean and gamma (a sum over M*D);
    dt takes none. Clip ties split their gradient as jnp.clip does."""
    args = _pf_inputs(case)
    kw = dict(clip=PF_CLIP, delta_mode=delta_mode)
    m, d = case[1], case[2]
    rng = np.random.default_rng(32)
    cts = [_f(rng, m, d), _f(rng, m, d)]
    want = _jax_grads(functools.partial(jref.pres_filter_ref, **kw), args,
                      cts)
    got = _port_grads(functools.partial(ops.pres_filter, **kw), args,
                      (0, 1, 2, 4), cts)
    for i, name in ((0, "s_prev"), (1, "s_meas"), (2, "delta_mean"),
                    (4, "gamma")):
        _close(got[i].numpy(), want[i], 1e-5, f"d{name}")


# ---------------------------------------------------------------------------
# memory_update (dense)
# ---------------------------------------------------------------------------

# (name, M, D, Din)
MD_CASES = [("m1", 1, 8, 8), ("ragged", 130, 16, 16),
            ("din_ne_d", 37, 12, 20)]


def _md_inputs(case, seed=41):
    _, m, d, din = case
    rng = np.random.default_rng(seed)
    return [_f(rng, m, din), _f(rng, m, d, scale=0.5),
            _f(rng, din, 3 * d, scale=din ** -0.5),
            _f(rng, d, 3 * d, scale=d ** -0.5), _f(rng, 3 * d, scale=0.1),
            _f(rng, m, d, scale=0.3),
            np.round(rng.random(m) * 3).astype(np.float32), np.float32(0.37)]


@pytest.mark.parametrize("delta_mode", ["transition", "innovation"])
@pytest.mark.parametrize("case", MD_CASES, ids=[c[0] for c in MD_CASES])
def test_memory_update_matches_jax(case, delta_mode):
    args = _md_inputs(case)
    kw = dict(clip=1.0, delta_mode=delta_mode)
    got = ops.memory_update(*[_t(a) for a in args], **kw)
    pallas = jmu._memory_update_pallas(*[jnp.asarray(a) for a in args],
                                       interpret=True, **kw)
    oracle = jax.jit(functools.partial(jref.memory_update_ref, **kw))(*args)
    for name, g, p, o in zip(("s_meas", "fused", "delta"), got, pallas,
                             oracle):
        _close(g.numpy(), p, 1e-5, f"{name} vs Pallas")
        _close(g.numpy(), o, 1e-5, f"{name} vs oracle")


@pytest.mark.parametrize("case", MD_CASES[1:], ids=[c[0] for c in
                                                    MD_CASES[1:]])
def test_memory_update_grads_match_jax(case):
    args = _md_inputs(case)
    kw = dict(clip=1.0, delta_mode="transition")
    m, d = case[1], case[2]
    rng = np.random.default_rng(42)
    cts = [_f(rng, m, d) for _ in range(3)]
    want = _jax_grads(functools.partial(jref.memory_update_ref, **kw), args,
                      cts)
    diff = (0, 1, 2, 3, 4, 5, 7)
    got = _port_grads(functools.partial(ops.memory_update, **kw), args, diff,
                      cts)
    names = ("x", "h", "w", "u", "b", "delta_mean", "scale", "gamma")
    for i in diff:
        _close(got[i].numpy(), want[i], 1e-5, f"d{names[i]}")


# ---------------------------------------------------------------------------
# the rnn cell and its parameters
# ---------------------------------------------------------------------------


def _jcfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
                d_embed=16, n_neighbors=4, use_kernels=True)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _tcfg(jcfg):
    return tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))


def test_rnn_cell_and_params_match_jax(tiny_stream):
    """rnn_cell against JAX's, and the rnn parameter tree of JAX's
    init_params through the bridge: the port's shapes, both inits."""
    rng = np.random.default_rng(51)
    p = {"w": _f(rng, 20, 12, scale=0.2), "u": _f(rng, 12, 12, scale=0.3),
         "b": _f(rng, 12, scale=0.1)}
    x, h = _f(rng, 9, 20), _f(rng, 9, 12)
    want = jax.jit(jmodules.rnn_cell)(p, x, h)
    got = tmodules.rnn_cell({k: _t(v) for k, v in p.items()}, _t(x), _t(h))
    _close(got.numpy(), want, 1e-6, "rnn_cell")
    jcfg = _jcfg(tiny_stream, memory_cell="rnn", d_msg=20)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    shapes = tmdgnn.param_shapes(_tcfg(jcfg))
    assert shapes["mem"] == {"w": (20, 16), "u": (16, 16), "b": (16,)}
    own = tmdgnn.init_params(_tcfg(jcfg), torch.Generator().manual_seed(0),
                             "cpu")
    for tree in (tparams, own):
        assert {k: tuple(v.shape) for k, v in tree["mem"].items()} == \
            shapes["mem"]


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _jstate_np(state):
    return {"memory": {"mem": np.array(state["memory"].mem),
                       "last_update": np.array(state["memory"].last_update)},
            "neighbors": {k: np.array(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.array(state["pres"].n),
                     "xi": np.array(state["pres"].xi),
                     "psi": np.array(state["pres"].psi)}}


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


def _assert_tree(tp, jp, tol, path="", floor=1.0):
    if isinstance(jp, dict):
        for k in jp:
            _assert_tree(tp[k], jp[k], tol, f"{path}/{k}", floor)
    else:
        _close(tp.detach().numpy(), np.asarray(jp), tol, path, floor)


def _assert_moments(tmu, jmu_, tol):
    """First moments (0.1 x the gradients after one step): every leaf
    within `tol` of the largest moment of the tree, and within 1e-2 of its
    own largest entry. A leaf's own scale is not held tighter: the output
    bias's and the PRES gate's gradients are sums over hundreds of terms
    that cancel to 1e-4 of their size, where fp32 sums in another order
    differ by 1e-4 of the result (measured: 1.4e-4 on dec/b2)."""
    flat = lambda t, j, p="": ([x for k in j for x in flat(t[k], j[k],
                                                           f"{p}/{k}")]
                               if isinstance(j, dict) else
                               [(p, t.detach().numpy(), np.asarray(j))])
    leaves = flat(tmu, jmu_)
    top = max(float(np.abs(j).max(initial=0.0)) for _, _, j in leaves)
    for path, t, j in leaves:
        _close(t, j, tol, f"mu{path}", floor=top)
        _close(t, j, 1e-2, f"mu{path} (own scale)", floor=0.0)


def _assert_state(ts, js, tol):
    a, b = bridge.state_to_numpy(ts), _jstate_np(js)
    for k in ("nbr", "t", "ptr"):
        np.testing.assert_array_equal(a["neighbors"][k], b["neighbors"][k])
    np.testing.assert_array_equal(a["memory"]["last_update"],
                                  b["memory"]["last_update"])
    np.testing.assert_array_equal(a["pres"]["n"], b["pres"]["n"])
    _close(a["memory"]["mem"], b["memory"]["mem"], tol, "memory table")
    for k in ("xi", "psi"):
        _close(a["pres"][k], b["pres"][k], 1e-4, f"tracker {k}")


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """The jitted JAX step of `jcfg` (lag-one or pipelined), compiled once
    for every test that trains that configuration."""
    if jcfg.pipeline_depth:
        return jpipeline.make_pipelined_train_step(jcfg, joptim.adamw(1e-3))
    return jloop.make_train_step(jcfg, joptim.adamw(1e-3))


def _setup(jcfg, seed=0):
    """Same parameters, state and optimizer on both sides."""
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    jstate = jmdgnn.init_state(jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    return (jparams, jopt.init(jparams), jstate,
            tparams, topt, topt.init(tparams), tstate)


@pytest.fixture
def routes(monkeypatch):
    """Counts the forward calls of the memory-stage kernels by name,
    through their registry entries (on the CPU the launch counters stay 0:
    the plain versions run)."""
    calls = {}
    for name in ("pres_filter", "memory_update_table", "gru_cell",
                 "memory_update"):
        spec = ops.REGISTRY[name]
        calls[name] = 0

        def ref(*a, _fn=spec.ref, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setitem(ops.REGISTRY, name,
                            dataclasses.replace(spec, ref=ref))
    return calls


# configuration -> the memory-stage kernel each step must call
STEP_CASES = [
    ("rnn-pres", dict(memory_cell="rnn", use_pres=True), "pres_filter"),
    ("rnn-std", dict(memory_cell="rnn"), None),
    ("rnn-time", dict(memory_cell="rnn", use_pres=True, pres_scale="time",
                      delta_mode="innovation"), "pres_filter"),
    ("gru-time", dict(use_pres=True, pres_scale="time"),
     "memory_update_table"),
    ("gru-mean", dict(use_pres=True, aggregator="mean"),
     "memory_update_table"),
    ("rnn-mean", dict(memory_cell="rnn", use_pres=True, aggregator="mean"),
     "pres_filter"),
]


@pytest.mark.parametrize("kw,route", [c[1:] for c in STEP_CASES],
                         ids=[c[0] for c in STEP_CASES])
def test_train_steps_match_jax(tiny_stream, tiny_spec, routes, kw, route):
    """Steps 1..3 of the lag-one step at 1e-5 then 1e-4: the rnn cell with
    PRES (the unfused route: the cell, then `pres_filter`) and without
    (Alg. 1), the "time" scale on both PRES routes, and the mean
    aggregator."""
    jcfg = _jcfg(tiny_stream, **kw)
    (jparams, jos, jstate,
     tparams, topt, tos, tstate) = _setup(jcfg)
    jstep = _jax_step(jcfg)
    tstep = tloop.make_train_step(_tcfg(jcfg), topt)
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], *dst)
        jparams, jos, jstate, jm = jstep(jparams, jos, jstate, jb[i - 1],
                                         jb[i], neg)
        tparams, tos, tstate, tm = tstep(tparams, tos, tstate,
                                         _tbatch(jb[i - 1]), _tbatch(jb[i]),
                                         _tbatch(neg))
        tol = 1e-5 if i == 1 else 1e-4
        want_loss = float(jm["loss"])
        assert abs(float(tm["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
        for k in ("logit_p", "logit_n"):
            _close(tm[k].numpy(), jm[k], 1e-4, k)
        _assert_state(tstate, jstate, tol)
        _assert_tree(tparams, jparams, tol, "param")
        _assert_moments(tos["mu"], jos["mu"], tol)
        assert tstate["memory"].mem.grad_fn is None
    want_calls = {k: 0 for k in routes}
    if route is not None:
        want_calls[route] = 3
    assert routes == want_calls
    assert not any(ops.launch_counts().values())
    if kw.get("use_pres"):
        # the memory cell and the message MLP train
        assert float(tos["mu"]["mem"]["w"].abs().max()) > 0.0
        assert float(tos["mu"]["pres"]["gamma_logit"].abs()) > 0.0


def test_rnn_epoch_and_evaluate_match_jax(tiny_stream, tiny_spec):
    """One epoch of the rnn cell with PRES and the evaluation after it,
    run_epoch / evaluate of both packages with the same negatives."""
    jcfg = _jcfg(tiny_stream, memory_cell="rnn", use_pres=True)
    tcfg = _tcfg(jcfg)
    (jparams, jos, jstate, tparams, topt, tos, tstate) = _setup(jcfg)
    train_s, val_s, _ = tiny_stream.chronological_split(0.6, 0.3)
    dst = _dst(tiny_spec)

    def jax_negatives(key, batches):
        out = []
        for b in batches[1:]:
            key, sub = jax.random.split(key)
            out.append(_tbatch(jsample(sub, b, *dst)))
        return out

    jtb, jvb = train_s.temporal_batches(B), val_s.temporal_batches(B)
    k_train, k_val = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    jparams, jos, jstate, jres = jloop.run_epoch(
        jparams, jos, jstate, jtb, jcfg, _jax_step(jcfg), k_train, dst)
    _, jvap, jvauc = jloop.evaluate(jparams, jstate, jvb, jcfg,
                                    jloop.make_eval_step(jcfg), k_val, dst)
    ttb = _tstream(train_s).temporal_batches(B, "cpu")
    tvb = _tstream(val_s).temporal_batches(B, "cpu")
    tparams, tos, tstate, tres = tloop.run_epoch(
        tparams, tos, tstate, ttb, tcfg, tloop.make_train_step(tcfg, topt),
        None, dst, negatives=jax_negatives(k_train, jtb))
    _, tvap, tvauc = tloop.evaluate(
        tparams, tstate, tvb, tcfg, tloop.make_eval_step(tcfg), None, dst,
        negatives=jax_negatives(k_val, jvb))
    assert abs(tres.ap - jres.ap) <= 1e-3
    assert abs(tres.loss - jres.loss) <= 1e-4 * abs(jres.loss)
    assert abs(tvap - jvap) <= 1e-3 and abs(tvauc - jvauc) <= 1e-3
    _assert_state(tstate, jstate, 1e-4)


# ---------------------------------------------------------------------------
# the pipelined schedule
# ---------------------------------------------------------------------------


def _jpstate_np(ps):
    return {"read_mem": np.array(ps.read_mem),
            "read_last_update": np.array(ps.read_last_update),
            "pending": np.array(ps.pending), "tick": int(ps.tick)}


def test_stale_read_table_time_matches_jax(tiny_stream):
    """The "time" fill: scale max(live - snapshot last_update, 0), rows
    whose times did not move pass unchanged."""
    jcfg = _jcfg(tiny_stream, use_pres=True, pres_scale="time",
                 pipeline_depth=2)
    rng = np.random.default_rng(61)
    n = jcfg.n_nodes
    snap = {"read_mem": _f(rng, n, 16),
            "read_last_update": (rng.random(n) * 50).astype(np.float32),
            "pending": np.zeros(n, np.float32), "tick": 1}
    live = snap["read_last_update"] + np.where(
        rng.random(n) < 0.5, 0.0, rng.random(n) * 3).astype(np.float32)
    live[:3] -= 1.0                                   # clamped to 0
    cnt = rng.integers(0, 3, (n, 2)).astype(np.float32)
    xi = _f(rng, n, 2, 16) * cnt[..., None]
    psi = xi ** 2 + rng.random((n, 2, 16)).astype(np.float32)
    jstate = jmdgnn.init_state(jcfg)
    jtrack = jstate["pres"].__class__(n=jnp.asarray(cnt), xi=jnp.asarray(xi),
                                      psi=jnp.asarray(psi))
    np_state = _jstate_np(jstate)
    np_state["pres"] = {"n": cnt, "xi": xi, "psi": psi}
    tstate = bridge.state_from_numpy(np_state, "cpu")
    jps = jpipeline.PipelineState(**{k: jnp.asarray(v)
                                     for k, v in snap.items()})
    want = np.asarray(jax.jit(functools.partial(
        jpipeline.stale_read_table, jcfg))(jtrack, jps, jnp.asarray(live)))
    tps = bridge.pipeline_state_from_numpy(snap, "cpu")
    got = tpipeline.stale_read_table(_tcfg(jcfg), tstate["pres"], tps,
                                     _t(live)).numpy()
    _close(got, want, 1e-6, "filled table")
    still = live <= snap["read_last_update"]
    np.testing.assert_array_equal(got[still], snap["read_mem"][still])
    assert np.abs(got - snap["read_mem"]).max() > 0.1
    with pytest.raises(ValueError, match="live last_update"):
        tpipeline.stale_read_table(_tcfg(jcfg), tstate["pres"], tps)


PIPE_CASES = [("rnn", dict(memory_cell="rnn")),
              ("gru-time", dict(pres_scale="time"))]


@pytest.mark.parametrize("kw", [c[1] for c in PIPE_CASES],
                         ids=[c[0] for c in PIPE_CASES])
def test_pipelined_steps_match_jax(tiny_stream, tiny_spec, kw):
    """Steps 1..3 at depth 2 with PRES: the rnn cell's unfused route, and
    the "time" scale of the memory stage and of the staleness fill."""
    jcfg = _jcfg(tiny_stream, use_pres=True, pipeline_depth=2, **kw)
    (jparams, jos, jstate, tparams, topt, tos, tstate) = _setup(jcfg)
    jps = jpipeline.PipelineState.init(jstate["memory"])
    tps = tpipeline.PipelineState.init(tstate["memory"])
    jstep = _jax_step(jcfg)
    tstep = tpipeline.make_pipelined_train_step(_tcfg(jcfg), topt)
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], *dst)
        jparams, jos, jstate, jps, jm = jstep(jparams, jos, jstate, jps,
                                              jb[i - 1], jb[i], neg)
        tparams, tos, tstate, tps, tm = tstep(
            tparams, tos, tstate, tps, _tbatch(jb[i - 1]), _tbatch(jb[i]),
            _tbatch(neg))
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-5 * abs(want)
        for k in ("logit_p", "logit_n"):
            _close(tm[k].numpy(), jm[k], 1e-4, k)
        _assert_state(tstate, jstate, 1e-5)
        got, want_ps = bridge.pipeline_state_to_numpy(tps), _jpstate_np(jps)
        _close(got["read_mem"], want_ps["read_mem"], 1e-5, "read_mem")
        for k in ("read_last_update", "pending", "tick"):
            np.testing.assert_array_equal(got[k], want_ps[k])
        _assert_tree(tparams, jparams, 1e-5, "param")
        _assert_moments(tos["mu"], jos["mu"], 1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_rnn_serving_matches_jax(tiny_stream, tiny_spec, routes):
    """ServeEngine ingest (memory, rings, trackers), query and top-k of the
    rnn cell with PRES against the JAX engine; every fold goes through
    `pres_filter`."""
    dst = _dst(tiny_spec)
    jcfg = _jcfg(tiny_stream, memory_cell="rnn", use_pres=True)
    params, _ = jmdgnn.init_params(jax.random.PRNGKey(3), jcfg)
    state = jmdgnn.init_state(jcfg)
    buckets = (16, 64)
    je = JEngine(jcfg, params, state, item_range=dst,
                 batcher=JBatcher(buckets=buckets, d_edge=jcfg.d_edge))
    te = ServeEngine(_tcfg(jcfg),
                     bridge.params_from_numpy(jax.tree.map(np.array, params),
                                              "cpu"),
                     bridge.state_from_numpy(_jstate_np(state), "cpu"),
                     item_range=dst, device="cpu",
                     batcher=MicroBatcher(buckets=buckets,
                                          d_edge=jcfg.d_edge))
    s, d, t, f = (tiny_stream.src, tiny_stream.dst, tiny_stream.t,
                  tiny_stream.feat)
    lo = 0
    for i, n in enumerate((40, 3, 64, 17, 100)):
        je.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        te.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        lo += n
        _assert_state(te.state, je.state, 1e-5 if i == 0 else 1e-4)
    # 100 events split into two folds of the 64-row bucket
    assert routes["pres_filter"] == 6
    assert routes["memory_update_table"] == routes["gru_cell"] == 0
    q = slice(lo, lo + 30)
    _close(te.query(s[q], d[q], t[q]), je.query(s[q], d[q], t[q]), 1e-4,
           "query scores")
    jv, _ = je.recommend_topk(s[lo:lo + 4], t[lo:lo + 4], 5)
    tv, _ = te.recommend_topk(s[lo:lo + 4], t[lo:lo + 4], 5)
    _close(tv, jv, 1e-4, "top-k scores")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_launch_train_cli_time_scale_on_cpu(capsys):
    """`--pres-scale time` runs an epoch through the train CLI (it was
    refused before the "time" scale was ported)."""
    from repro_torch.launch import train as ttrain
    hist = ttrain.main(["--dataset", "wiki-small", "--pres", "--pres-scale",
                        "time", "--use-kernels", "--device", "cpu",
                        "--d-mem", "8", "--batch-size", "2000", "--epochs",
                        "1"])
    assert "epoch 0: loss=" in capsys.readouterr().out
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert 0.0 <= hist[0]["val_ap"] <= 1.0
