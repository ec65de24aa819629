"""The captured training and evaluation steps (repro_torch.train.capture:
the lag-one, pipelined and eval steps, and the scan engine on the same
helper) on the CPU, where every step runs its eager body.

On the card each step replays a CUDA graph, which holds only if its body
waits for nothing on the host: the pipelined step (depth 1 and 2, refresh
and non-refresh steps) and the eval step run here on meta tensors for
every route of tests/test_torch_scan.py, where a host sync raises. A step
made by default and one made with `capture=False` give the same bits (the
same body on the CPU), and `evaluate` through the eval step's own state
buffer is held against the JAX package's `evaluate`.

Tolerances: the default step against `capture=False` exact; against JAX
(its negatives injected) the final evaluation state and AP as
tests/test_torch_train.py holds them: table 1e-4 of max(1, |value|),
trackers 1e-4, times and rings exact, AP and AUC 1e-3."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.graph.negatives import sample_negatives as jsample
from repro.models import mdgnn as jmdgnn
from repro.train import loop as jloop

from repro_torch import bridge
from repro_torch.graph import events as tevents
from repro_torch.graph.negatives import sample_negatives
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.models.modules import MemoryState
from repro_torch.optim import optimizers as toptim
from repro_torch.train import capture as tcapture
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline
from repro_torch.train import scan as tscan
from repro_torch.utils.tree import tree_map

from test_torch_scan import DST, ROUTES

B = 100             # temporal batch size on the 600-event tiny stream
META = torch.device("meta")


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _cfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=8, d_msg=8, d_time=4,
                d_embed=8, n_neighbors=4, use_pres=True, use_kernels=True)
    base.update(kw)
    return tmdgnn.MDGNNConfig(**base)


def _on_meta(b):
    return tevents.EventBatch(*(getattr(b, f).to(META) for f in
                                ("src", "dst", "t", "feat", "mask")))


def _leaves(*trees):
    return [x for t in trees for x in tcapture.leaves(t)]


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# every route's bodies without a host sync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pipelined_and_eval_steps_on_meta(tiny_stream, route):
    """The pipelined step at depth 1 (every step refreshes) and depth 2
    (a step of staleness 1, which does not refresh, then one of 2), and
    the eval step, on meta tensors (shapes without data), where
    `torch.nonzero`, a boolean-mask index or a read of a value on the
    host raises: on the card each is captured as a CUDA graph."""
    # the pipelined schedule needs the coherence term (Alg. 1 routes too)
    cfg = _cfg(tiny_stream, use_smoothing=True, **ROUTES[route])
    batches = [_on_meta(b) for b in
               _tstream(tiny_stream).temporal_batches(B, "cpu")[:4]]
    negs = [dataclasses.replace(b, dst=torch.flip(b.dst, (0,)))
            for b in batches[1:]]
    opt = toptim.adamw(1e-3)
    for depth, want in ((1, [(1, 0)] * 2), (2, [(1, 1), (2, 0)])):
        c = dataclasses.replace(cfg, pipeline_depth=depth, obs_metrics=True)
        step = tpipeline.make_pipelined_train_step(c, opt)
        params = tmdgnn.init_params(c, None, META)
        state = tmdgnn.init_state(c, META)
        carry = (params, opt.init(params), state,
                 tpipeline.PipelineState.init(state["memory"]))
        got = []
        for i in range(2):
            *carry, m = step(*carry, batches[i], batches[i + 1], negs[i])
            got.append((m["staleness"], carry[3].tick))
            assert m["loss"].shape == () and m["logit_p"].shape == (B,)
            assert m["obs"].device == META
        assert got == want and step.captured is False
    params = tmdgnn.init_params(cfg, None, META)
    state = tmdgnn.init_state(cfg, META)
    eval_step = tloop.make_eval_step(cfg)
    for i in range(2):
        state, lp, ln = eval_step(params, state, batches[i], batches[i + 1],
                                  negs[i])
        assert lp.shape == ln.shape == (B,)
    assert state["memory"].mem.shape == (cfg.n_nodes, cfg.d_mem)
    assert eval_step.captured is False and eval_step.eager_reason is None


# ---------------------------------------------------------------------------
# the static reasons to run eagerly
# ---------------------------------------------------------------------------


def test_static_eager_reasons(tiny_stream):
    """Off CUDA every step and the scan engine run eagerly and report
    `captured` False with no reason; on a CUDA device the reasons are
    static: `capture=False`, the caller's, shards on several devices."""
    cuda = torch.device("cuda", 0)
    cfg = _cfg(tiny_stream)
    assert tcapture.why_eager(torch.device("cpu"), True) == "not on CUDA"
    assert tcapture.why_eager(META, True) == "not on CUDA"
    assert tcapture.why_eager(cuda, False) == "capture=False"
    assert tcapture.why_eager(cuda, True, reason="negatives injected") \
        == "negatives injected"
    two = MemoryState(mem=[torch.zeros(2, 8), torch.zeros(2, 8, device=META)],
                      last_update=[torch.zeros(2), torch.zeros(2)])
    assert tcapture.why_eager(
        cuda, True, dataclasses.replace(cfg, n_shards=2),
        {"memory": two}) == "the shards are on more than one device"
    assert tcapture.why_eager(cuda, True, cfg) is None
    batches = _tstream(tiny_stream).temporal_batches(B, "cpu")[:3]
    neg = sample_negatives(torch.Generator().manual_seed(0), batches[1], *DST)
    opt = toptim.adamw(1e-3)
    for capture in (True, False):
        pcfg = dataclasses.replace(cfg, pipeline_depth=2)
        steps = [tloop.make_train_step(cfg, opt, capture=capture),
                 tpipeline.make_train_step(pcfg, opt, capture=capture),
                 tloop.make_eval_step(cfg, capture=capture)]
        assert all(s.captured is None for s in steps)
        params = tmdgnn.init_params(cfg, None, "cpu")
        state = tmdgnn.init_state(cfg, "cpu")
        steps[0](params, opt.init(params), state, batches[0], batches[1], neg)
        steps[1](params, opt.init(params), state,
                 tpipeline.PipelineState.init(state["memory"]), batches[0],
                 batches[1], neg)
        steps[2](params, state, batches[0], batches[1], neg)
        eng = tscan.ScanEngine(dataclasses.replace(cfg, scan_chunk=2), opt,
                               capture=capture)
        eng.run_epoch(params, opt.init(params), state, batches,
                      torch.Generator().manual_seed(0), DST)
        for s in steps + [eng]:
            assert s.captured is False and s.eager_reason is None
            assert s.capture is capture


# ---------------------------------------------------------------------------
# the default steps against capture=False, and evaluate's own state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 2], ids=["lag-one", "pipelined"])
def test_default_step_equals_capture_false(tiny_stream, depth):
    """An epoch and `evaluate` with the steps made by default and with
    `capture=False`, from one start and one generator seed: parameters,
    moments, state, losses, per-step APs, val AP and AUC and the
    evaluation state, bit for bit."""
    cfg = _cfg(tiny_stream, pipeline_depth=depth, obs_metrics=True)
    train_s, val_s, _ = _tstream(tiny_stream).chronological_split(0.6, 0.3)
    batches = train_s.temporal_batches(B, "cpu")
    val = val_s.temporal_batches(B, "cpu")
    runs = []
    for capture in (True, False):
        opt = toptim.adamw(1e-3)
        params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt_state, state = opt.init(params), tmdgnn.init_state(cfg, "cpu")
        gen = torch.Generator().manual_seed(3)
        params, opt_state, state, res = tpipeline.run_epoch(
            params, opt_state, state, batches, cfg,
            tpipeline.make_train_step(cfg, opt, capture=capture), gen, DST,
            collect_logits=True)
        ev_state, vap, vauc = tloop.evaluate(
            params, state, val, cfg,
            tloop.make_eval_step(cfg, capture=capture), gen, DST)
        runs.append((_leaves(params, opt_state, state, ev_state),
                     (res.loss, res.ap, res.aps, res.obs, vap, vauc)))
    _assert_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


def test_evaluate_owns_its_state_buffer(tiny_stream, tiny_spec):
    """`evaluate` through an eval step copies the caller's state into the
    step's own buffer (the same buffer at every call, so a graph is
    captured once a run), leaves the caller's state as it was, returns a
    state that a later call does not overwrite, and gives the JAX
    package's `evaluate` (its negatives injected; the plain route, whose
    JAX eval step compiles fastest: tests/test_torch_train.py holds the
    kernel route's `evaluate`, through the same buffer, against JAX's)."""
    jcfg = jmdgnn.MDGNNConfig(
        variant="tgn", n_nodes=tiny_stream.num_nodes,
        d_edge=tiny_stream.feat_dim, d_mem=8, d_msg=8, d_time=4, d_embed=8,
        n_neighbors=4, use_pres=True, use_kernels=False)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    # the port's draw of the parameters on both sides (JAX's init compiles
    # for seconds)
    tparams = tmdgnn.init_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    jparams = jax.tree.map(jax.numpy.asarray,
                           tree_map(lambda t: t.numpy(), tparams))
    dst = (tiny_spec.n_users, tiny_spec.n_users + tiny_spec.n_items)
    head, val_s, _ = tiny_stream.chronological_split(0.6, 0.3)
    # a trained-looking state: the first 3 batches folded by the eval step
    tstate = tmdgnn.init_state(tcfg, "cpu")
    warm = _tstream(head).temporal_batches(B, "cpu")[:4]
    g = torch.Generator().manual_seed(1)
    fold = tloop.make_eval_step(tcfg)
    for a, b in zip(warm, warm[1:]):
        tstate, _, _ = fold(tparams, tstate, a, b,
                            sample_negatives(g, b, *dst))
    jstate = bridge.state_to_numpy(tstate)
    jvb = val_s.temporal_batches(B)
    key, negs = jax.random.PRNGKey(8), []
    for b in jvb[1:]:
        key, sub = jax.random.split(key)
        jb = jsample(sub, b, *dst)
        negs.append(tevents.EventBatch.from_numpy(
            np.array(jb.src), np.array(jb.dst), np.array(jb.t),
            np.array(jb.feat), np.array(jb.mask), "cpu"))
    jst = jmdgnn.init_state(jcfg)
    jst = {"memory": type(jst["memory"])(**jstate["memory"]),
           "neighbors": dict(jstate["neighbors"]),
           "pres": type(jst["pres"])(**jstate["pres"])}
    jst = jax.tree.map(jax.numpy.asarray, jst)
    jev, jvap, jvauc = jloop.evaluate(jparams, jst, jvb, jcfg,
                                      jloop.make_eval_step(jcfg),
                                      jax.random.PRNGKey(8), dst)
    before = _leaves(tmdgnn.clone_state(tstate))
    step = tloop.make_eval_step(tcfg)
    tvb = _tstream(val_s).temporal_batches(B, "cpu")
    first, vap, vauc = tloop.evaluate(tparams, tstate, tvb, tcfg, step,
                                      None, dst, negatives=negs)
    own = step.own_state(tstate)
    kept = _leaves(tmdgnn.clone_state(first))
    again, vap2, _ = tloop.evaluate(tparams, tstate, tvb, tcfg, step, None,
                                    dst, negatives=negs)
    assert step.own_state(tstate) is own
    _assert_equal(_leaves(tstate), before)          # the caller's state
    _assert_equal(_leaves(first), kept)             # not overwritten
    _assert_equal(_leaves(again), kept)
    assert vap2 == vap
    assert all(x.data_ptr() != y.data_ptr()
               for x, y in zip(_leaves(first), _leaves(own)))
    assert abs(vap - jvap) <= 1e-3 and abs(vauc - jvauc) <= 1e-3
    got = bridge.state_to_numpy(first)
    for k in ("nbr", "t", "ptr"):
        np.testing.assert_array_equal(got["neighbors"][k],
                                      np.array(jev["neighbors"][k]))
    np.testing.assert_array_equal(got["memory"]["last_update"],
                                  np.array(jev["memory"].last_update))
    want = np.array(jev["memory"].mem, np.float64)
    err = np.abs(got["memory"]["mem"] - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max())
