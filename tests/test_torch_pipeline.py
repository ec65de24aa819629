"""The port's pipelined schedule (`repro_torch.train.pipeline`, the
`pres_predict` kernel module, the prefetch iterator) against the JAX
package on the CPU.

Both sides start from the same parameters, state and snapshot (JAX's,
moved through `repro_torch.bridge`) and score the same negatives (JAX's
draws, injected). The JAX step runs with use_kernels=True, which on the
CPU resolves `pres_predict` and the memory kernel to their jitted jnp
oracles; the port's run their plain PyTorch versions through the autograd
Functions the card runs.

Tolerances: batches byte for byte; the staleness fill 1e-6 of its scale
(one multiply, clip and add a row); loss 1e-5 relative; logits 1e-4;
live table, snapshot and parameters 1e-5 of their scale over three steps
(fp32 sums in another order; measured up to 3e-6); first moments the
same, each leaf relative to its own largest entry (gradients: never
absolute); `pending`, `tick` and the snapshot times exact; epoch AP 1e-3
and the epoch's table 1e-4 (rounding carried through five steps)."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.core import pres as jpres
from repro.graph.events import prefetch as jprefetch
from repro.graph.negatives import sample_negatives as jsample
from repro.kernels import memory_update as jmu
from repro.kernels import ref as jref
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.train import pipeline as jpipeline

from repro_torch import bridge
from repro_torch.core import pres as tpres
from repro_torch.graph import events as tevents
from repro_torch.kernels import ops
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import pipeline as tpipeline

B = 100            # temporal batch size on the 600-event tiny stream


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


def _close(got, want, tol, what, floor=1.0):
    """|got - want| <= tol * max(floor, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol * max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _assert_tree(tp, jp, tol, path="", floor=1.0):
    if isinstance(jp, dict):
        for k in jp:
            _assert_tree(tp[k], jp[k], tol, f"{path}/{k}", floor)
    else:
        _close(tp.detach().numpy(), np.asarray(jp), tol, path, floor)


def _jstate_np(state):
    return {"memory": {"mem": np.array(state["memory"].mem),
                       "last_update": np.array(state["memory"].last_update)},
            "neighbors": {k: np.array(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.array(state["pres"].n),
                     "xi": np.array(state["pres"].xi),
                     "psi": np.array(state["pres"].psi)}}


def _jpstate_np(ps):
    return {"read_mem": np.array(ps.read_mem),
            "read_last_update": np.array(ps.read_last_update),
            "pending": np.array(ps.pending), "tick": int(ps.tick)}


def _jcfg(stream, depth, use_pres=True):
    return jmdgnn.MDGNNConfig(
        variant="tgn", n_nodes=stream.num_nodes, d_edge=stream.feat_dim,
        d_mem=16, d_msg=16, d_time=8, d_embed=16, n_neighbors=4,
        use_pres=use_pres, use_kernels=True, pipeline_depth=depth)


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """The jitted JAX pipelined step of `jcfg`, compiled once for every
    test that trains that configuration."""
    return jpipeline.make_pipelined_train_step(jcfg, joptim.adamw(1e-3))


def _setup(stream, depth):
    jcfg = _jcfg(stream, depth)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jmdgnn.init_state(jcfg)
    jps = jpipeline.PipelineState.init(jstate["memory"])
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams), "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    tps = tpipeline.PipelineState.init(tstate["memory"])
    want = _jpstate_np(jps)
    for k, v in bridge.pipeline_state_to_numpy(tps).items():
        np.testing.assert_array_equal(v, want[k])
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    return (jcfg, jparams, jopt.init(jparams), jstate, jps,
            tcfg, tparams, topt, topt.init(tparams), tstate, tps)


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def test_prefetch_matches_jax_carve(tiny_stream):
    """Order and tail padding: the same batches as the JAX carve, byte for
    byte, the node ids widened to int64 indices."""
    want = list(tiny_stream.iter_temporal_batches(77))
    got = list(_tstream(tiny_stream).prefetch_batches(77, "cpu", depth=3))
    assert len(got) == len(want) == tiny_stream.num_batches(77)
    for a, b in zip(want, got):
        for col in ("src", "dst", "t", "feat", "mask"):
            x, y = np.asarray(getattr(a, col)), getattr(b, col).numpy()
            assert x.shape == y.shape
            np.testing.assert_array_equal(y, x)
    tail = got[-1]
    assert int(tail.mask.sum()) == len(tiny_stream) - 7 * 77
    assert not tail.mask[-1] and int(tail.src[-1]) == 0


def test_prefetch_exception_close_and_depth():
    def gen():
        yield 1
        raise RuntimeError("boom")

    for pf in (jprefetch, tevents.prefetch):     # the same contract
        it = pf(gen(), depth=2)
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="boom"):
            next(it)
        with pytest.raises(StopIteration):       # ended, does not hang
            next(it)
    it = tevents.prefetch(iter(range(1000)), depth=2)
    assert next(it) == 0
    it.close()
    with pytest.raises(StopIteration):
        next(it)
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()             # the producer stopped
    with pytest.raises(ValueError, match="depth"):
        tevents.PrefetchIterator([1, 2], depth=0)


# ---------------------------------------------------------------------------
# pres_predict and the staleness fill
# ---------------------------------------------------------------------------

# (name, M, D, clip): D % 4 != 0 and M = 1 are the kernel's edge shapes
PP_CASES = [("m1", 1, 8, 1.0), ("ragged", 37, 12, 1.0), ("d_odd", 50, 7, 5.0)]


def _pp_inputs(case, seed=4):
    _, m, d, _ = case
    rng = np.random.default_rng(seed)
    scale = np.round(rng.random(m) * 4).astype(np.float32)  # counts, 0 incl.
    return [rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32), scale]


@pytest.mark.parametrize("case", PP_CASES, ids=[c[0] for c in PP_CASES])
def test_pres_predict_matches_jax(case):
    """Forward against the Pallas kernel (interpret) and the jnp oracle,
    and the Function's gradients against jitted jax.vjp of the oracle."""
    args, clip = _pp_inputs(case), case[3]
    jargs = [jnp.asarray(a) for a in args]
    want_pl = jmu._pres_predict_pallas(*jargs, clip=clip, interpret=True)
    fn = functools.partial(jref.pres_predict_ref, clip=clip)
    want = jax.jit(fn)(*jargs)
    targs = [torch.as_tensor(a).requires_grad_(True) for a in args]
    got = ops.pres_predict(*targs, clip=clip)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_pl),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    ct = np.random.default_rng(5).normal(size=args[0].shape).astype(
        np.float32)
    jg = jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(jargs, jnp.asarray(ct))
    got.backward(torch.as_tensor(ct))
    for t, w, name in zip(targs, jg, ("s_prev", "delta_mean", "scale")):
        _close(t.grad.numpy(), w, 1e-5, f"d{name}")


def _filled_trackers(tstate, jcfg, seed=6):
    """Random non-empty trackers, the same on both sides."""
    rng = np.random.default_rng(seed)
    n, d = jcfg.n_nodes, jcfg.d_mem
    cnt = rng.integers(0, 3, (n, 2)).astype(np.float32)
    xi = rng.normal(size=(n, 2, d)).astype(np.float32) * cnt[..., None]
    psi = xi ** 2 + rng.random((n, 2, d)).astype(np.float32)
    jp = jpres.PresState(n=jnp.asarray(cnt), xi=jnp.asarray(xi),
                         psi=jnp.asarray(psi))
    for t, a in ((tstate["pres"].n, cnt), (tstate["pres"].xi, xi),
                 (tstate["pres"].psi, psi)):
        t[:-1] = torch.as_tensor(a)
    return jp


@pytest.mark.parametrize("use_pres", [True, False], ids=["pres", "raw"])
def test_stale_read_table_matches_jax(tiny_stream, use_pres):
    """With filled trackers the Eq. 7 fill matches JAX's; with empty ones
    (no PRES) it is the raw snapshot, bit for bit."""
    jcfg = _jcfg(tiny_stream, 2, use_pres)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    n = jcfg.n_nodes
    snap = {"read_mem": rng.normal(size=(n, 16)).astype(np.float32),
            "read_last_update": rng.random(n).astype(np.float32),
            "pending": rng.integers(0, 4, n).astype(np.float32), "tick": 1}
    jstate = jmdgnn.init_state(jcfg)
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    jtrack = _filled_trackers(tstate, jcfg) if use_pres else jstate["pres"]
    jps = jpipeline.PipelineState(**{k: jnp.asarray(v)
                                     for k, v in snap.items()})
    tps = bridge.pipeline_state_from_numpy(snap, "cpu")
    want = np.asarray(jax.jit(functools.partial(
        jpipeline.stale_read_table, jcfg))(jtrack, jps,
                                          jstate["memory"].last_update))
    got = tpipeline.stale_read_table(tcfg, tstate["pres"], tps).numpy()
    if use_pres:
        _close(got, want, 1e-6, "filled table")
        assert np.abs(got - snap["read_mem"]).max() > 0.1   # a real fill
        # the non-kernel route (pres.predict) gives the same rows
        plain = tpres.predict(tstate["pres"], tps.read_mem,
                              tps.pending[:-1], clip=tcfg.pres_clip)
        _close(plain.numpy(), want, 1e-6, "pres.predict")
        idx = np.arange(0, n, 7)
        jpred = jpres.predict(jtrack, jnp.asarray(snap["read_mem"][idx]),
                              jnp.asarray(snap["pending"][idx]),
                              jnp.asarray(idx), clip=jcfg.pres_clip)
        tpred = tpres.predict(tstate["pres"],
                              torch.as_tensor(snap["read_mem"][idx]),
                              torch.as_tensor(snap["pending"][idx]),
                              torch.as_tensor(idx), clip=tcfg.pres_clip)
        _close(tpred.numpy(), jpred, 1e-6, "pres.predict on gathered rows")
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, snap["read_mem"])


# ---------------------------------------------------------------------------
# pipelined steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_steps_match_jax(tiny_stream, tiny_spec, depth):
    """Steps 1..3 of the pipelined schedule: loss, logits, live table,
    snapshot, pending counts, tick, parameters and first moments after
    each."""
    (jcfg, jparams, jos, jstate, jps,
     tcfg, tparams, topt, tos, tstate, tps) = _setup(tiny_stream, depth)
    jstep = _jax_step(jcfg)
    tstep = tpipeline.make_pipelined_train_step(tcfg, topt)
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], *dst)
        jparams, jos, jstate, jps, jm = jstep(jparams, jos, jstate, jps,
                                              jb[i - 1], jb[i], neg)
        tparams, tos, tstate, tps, tm = tstep(
            tparams, tos, tstate, tps, _tbatch(jb[i - 1]), _tbatch(jb[i]),
            _tbatch(neg))
        tol = 1e-5
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-5 * abs(want)
        assert tm["staleness"] == int(jm["staleness"])
        for k in ("logit_p", "logit_n"):
            _close(tm[k].numpy(), jm[k], 1e-4, k)
        _close(tstate["memory"].mem.numpy(), jstate["memory"].mem, tol,
               "live table")
        np.testing.assert_array_equal(tstate["memory"].last_update.numpy(),
                                      np.asarray(jstate["memory"].last_update))
        got, want_ps = bridge.pipeline_state_to_numpy(tps), _jpstate_np(jps)
        _close(got["read_mem"], want_ps["read_mem"], tol, "read_mem")
        for k in ("read_last_update", "pending", "tick"):
            np.testing.assert_array_equal(got[k], want_ps[k])
        _assert_tree(tparams, jparams, tol, "param")
        _assert_tree(tos["mu"], jos["mu"], tol, "mu", floor=0.0)
    # the coherence term is the memory module's only gradient path: alive
    for leaf in ("w", "u"):
        assert float(tos["mu"]["mem"][leaf].abs().max()) > 0.0
    assert float(tos["mu"]["msg"]["w1"].abs().max()) > 0.0
    assert tps.read_mem.data_ptr() != tstate["memory"].mem.data_ptr()


def test_pipelined_step_needs_the_coherence_term(tiny_stream):
    cfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(
        _jcfg(tiny_stream, 1, use_pres=False)))
    opt = toptim.adamw(1e-3)
    for bad in (cfg, dataclasses.replace(cfg, use_pres=True,
                                         use_smoothing=False),
                dataclasses.replace(cfg, use_smoothing=True, beta=0.0)):
        with pytest.raises(ValueError, match="freeze"):
            tpipeline.make_pipelined_train_step(bad, opt)
    tpipeline.make_pipelined_train_step(
        dataclasses.replace(cfg, use_smoothing=True, beta=0.1), opt)
    with pytest.raises(ValueError, match="pipeline_depth"):
        tpipeline.make_pipelined_train_step(
            dataclasses.replace(cfg, pipeline_depth=0), opt)


def test_pipelined_epoch_matches_jax(tiny_stream, tiny_spec):
    """One epoch at depth 2 through run_epoch, from prefetched batches,
    against the JAX epoch with its negatives injected."""
    (jcfg, jparams, jos, jstate, _,
     tcfg, tparams, topt, tos, tstate, _) = _setup(tiny_stream, 2)
    dst = _dst(tiny_spec)
    key = jax.random.PRNGKey(7)
    jtb = tiny_stream.temporal_batches(B)
    negs, k = [], key
    for b in jtb[1:]:
        k, sub = jax.random.split(k)
        negs.append(_tbatch(jsample(sub, b, *dst)))
    jparams, jos, jstate, jres = jpipeline.run_epoch(
        jparams, jos, jstate, jtb, jcfg, _jax_step(jcfg), key, dst)
    tparams, tos, tstate, tres = tpipeline.run_epoch(
        tparams, tos, tstate,
        _tstream(tiny_stream).prefetch_batches(B, "cpu", depth=2), tcfg,
        tpipeline.make_train_step(tcfg, topt), None, dst, negatives=negs)
    assert abs(tres.ap - jres.ap) <= 1e-3
    assert abs(tres.loss - jres.loss) <= 1e-4 * abs(jres.loss)
    _close(tstate["memory"].mem.numpy(), jstate["memory"].mem, 1e-4,
           "live table")


def test_depth0_delegates_to_the_lag_one_loop(tiny_stream):
    from repro_torch.train import loop as tloop
    cfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(_jcfg(tiny_stream, 0)))
    step = tpipeline.make_train_step(cfg, toptim.adamw(1e-3))
    assert step.__qualname__ == tloop.make_train_step(
        cfg, toptim.adamw(1e-3)).__qualname__
    with pytest.raises(ValueError, match="pipeline_depth"):
        tpipeline.make_train_step(dataclasses.replace(cfg, pipeline_depth=-1),
                                  toptim.adamw(1e-3))
