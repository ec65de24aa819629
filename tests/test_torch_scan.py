"""The port's macro-batch training (repro_torch.train.scan) on the CPU:
the macro-batches, the engine against the port's own lag-one loop, and
against the JAX package's ScanEngine.

Tolerances: macro-batches exact; the port's scan against its lag-one loop
exact (bit for bit: the same operations in the same order on the CPU);
against JAX's ScanEngine with JAX's negatives injected (its draws from
`jax.random` cannot be reproduced), parameters, memory table and loss
within 1e-5 of max(1, |value|), trackers 1e-4 (sums in another order),
last-update times and rings exact, AP 1e-3, as tests/test_torch_train.py
holds the lag-one loop."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.graph.negatives import sample_negatives as jsample
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.train import scan as jscan

from repro_torch import bridge
from repro_torch.graph import events as tevents
from repro_torch.graph.events import iter_macro_batches, stack_batches
from repro_torch.graph.negatives import sample_negatives, sample_negatives_in
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline
from repro_torch.train import scan as tscan
from repro_torch.utils.tree import tree_leaves

DST = (50, 80)          # the tiny stream's item band


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _cfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=8, d_msg=8, d_time=4,
                d_embed=8, n_neighbors=4, use_pres=True, use_kernels=True)
    base.update(kw)
    return tmdgnn.MDGNNConfig(**base)


def _setup(cfg, seed=0):
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
    opt = toptim.adamw(1e-3)
    return params, opt.init(params), tmdgnn.init_state(cfg, "cpu"), opt


def _flat_state(state):
    return tscan._state_leaves(state)


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _epoch(cfg, batches, seed=3, chunk=None, **kw):
    """One epoch of `cfg` from its seeded start: the lag-one loop when
    `chunk` is None, else the scan engine at that chunk."""
    params, opt_state, state, opt = _setup(cfg)
    gen = torch.Generator().manual_seed(seed)
    if chunk is None:
        return tloop.run_epoch(params, opt_state, state, batches, cfg,
                               tloop.make_train_step(cfg, opt), gen, DST,
                               **kw)
    c = dataclasses.replace(cfg, scan_chunk=chunk)
    return tscan.ScanEngine(c, opt).run_epoch(params, opt_state, state,
                                              batches, gen, DST, **kw)


# ---------------------------------------------------------------------------
# macro-batches and in-step negatives
# ---------------------------------------------------------------------------


def test_stack_batches_shapes_and_values(tiny_stream):
    batches = _tstream(tiny_stream).temporal_batches(100, "cpu")
    macro = stack_batches(batches[:3])
    assert macro.src.shape == (3, 100) and macro.feat.shape == (3, 100, 8)
    for i in range(3):
        for f in ("src", "dst", "t", "feat", "mask"):
            assert torch.equal(getattr(macro.at(i), f),
                               getattr(batches[i], f))
    with pytest.raises(ValueError, match="at least one"):
        stack_batches([])


def test_iter_macro_batches_overlap_tail_and_errors(tiny_stream):
    batches = _tstream(tiny_stream).temporal_batches(47, "cpu")   # K = 13
    macros = list(iter_macro_batches(iter(batches), 5))
    assert [m.src.shape[0] - 1 for m in macros] == [5, 5, 2]
    seen = [m.at(j) for m in macros for j in range(1, m.src.shape[0])]
    assert len(seen) == len(batches) - 1
    for got, want in zip(seen, batches[1:]):
        assert torch.equal(got.src, want.src) and torch.equal(got.t, want.t)
    # overlap by one: the last batch of macro k opens macro k + 1
    for a, b in zip(macros, macros[1:]):
        assert torch.equal(a.at(a.src.shape[0] - 1).src, b.at(0).src)
    with pytest.raises(ValueError, match="chunk"):
        list(iter_macro_batches(batches, 0))
    assert list(iter_macro_batches(batches[:1], 4)) == []
    assert list(iter_macro_batches([], 4)) == []


def test_sample_negatives_in_draws_the_host_loop_negatives(tiny_stream):
    batch = _tstream(tiny_stream).temporal_batches(100, "cpu")[1]
    a = sample_negatives(torch.Generator().manual_seed(1), batch, *DST)
    b = sample_negatives_in(torch.Generator().manual_seed(1), batch, *DST)
    for f in ("src", "dst", "t", "feat", "mask"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert int(b.dst.min()) >= DST[0] and int(b.dst.max()) < DST[1]


# ---------------------------------------------------------------------------
# the engine against the port's lag-one loop
# ---------------------------------------------------------------------------


# every route of the step: the memory_update_table kernel (PRES, the GRU
# cell, kernels) and the cell routes of mdgnn.memory_update
ROUTES = {
    "tgn-pres": dict(), "dense": dict(dedup_embed=False),
    "apan": dict(variant="apan"), "jodie": dict(variant="jodie"),
    "rnn-pres": dict(memory_cell="rnn"), "alg1": dict(use_pres=False),
    "plain": dict(use_kernels=False), "oracle": dict(kernels_mode="oracle"),
    "rnn-std": dict(memory_cell="rnn", use_pres=False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_check_schedule_and_captures(tiny_stream, route):
    """check_schedule's errors, and every route's macro step (3 lag-one
    steps: forward, backward and AdamW) on meta tensors (shapes without
    data), where `torch.nonzero`, a boolean-mask index or a read of a
    value on the host raises: on the card every route's macro is
    captured as one CUDA graph."""
    cfg = _cfg(tiny_stream, **ROUTES[route])
    with pytest.raises(ValueError, match="mutually exclusive"):
        tscan.check_schedule(dataclasses.replace(cfg, scan_chunk=2,
                                                 pipeline_depth=1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tscan.ScanEngine(dataclasses.replace(cfg, scan_chunk=4,
                                             pipeline_depth=2),
                         toptim.adamw(1e-3))
    with pytest.raises(ValueError, match=">= 1"):
        tscan.check_schedule(dataclasses.replace(cfg, scan_chunk=0))
    tscan.check_schedule(dataclasses.replace(cfg, scan_chunk=1,
                                             pipeline_depth=2))
    meta = torch.device("meta")
    on_meta = lambda b: tevents.EventBatch(
        *(getattr(b, f).to(meta) for f in ("src", "dst", "t", "feat",
                                           "mask")))
    batches = [on_meta(b) for b in
               _tstream(tiny_stream).temporal_batches(100, "cpu")[:4]]
    negs = [dataclasses.replace(b, dst=torch.flip(b.dst, (0,)))
            for b in batches[1:]]
    opt = toptim.adamw(1e-3)
    params = tmdgnn.init_params(cfg, None, meta)
    step = tscan.make_macro_step(dataclasses.replace(cfg, scan_chunk=3),
                                 opt, DST)
    _, _, state, m = step(params, opt.init(params),
                          tmdgnn.init_state(cfg, meta), None,
                          stack_batches(batches), negatives=negs)
    assert m["loss"].shape == (3,) and m["logit_p"].shape == (3, 100)
    assert state["memory"].mem.shape == (cfg.n_nodes, cfg.d_mem)


def test_chunk1_bit_exact_with_lag_one_loop(tiny_stream):
    cfg = _cfg(tiny_stream)
    batches = _tstream(tiny_stream).temporal_batches(100, "cpu")
    pa, oa, sa, ra = _epoch(cfg, batches)
    pb, ob, sb, rb = _epoch(cfg, batches, chunk=1)
    _assert_equal(tree_leaves(pa) + tree_leaves(oa) + _flat_state(sa),
                  tree_leaves(pb) + tree_leaves(ob) + _flat_state(sb))
    assert (ra.loss, ra.ap) == (rb.loss, rb.ap)


@pytest.mark.parametrize("variant", ["tgn", "apan"])
def test_chunk4_equals_chunk1_full_state(tiny_stream, variant):
    """Parameters, moments, memory, rings, trackers (and APAN's mailbox),
    loss, AP, per-step APs and the obs series: the same bits, from one
    generator seed (the negatives drawn in the step)."""
    cfg = _cfg(tiny_stream, variant=variant, obs_metrics=True)
    batches = _tstream(tiny_stream).temporal_batches(100, "cpu")
    pa, oa, sa, ra = _epoch(cfg, batches, chunk=1, collect_logits=True)
    eng = tscan.ScanEngine(dataclasses.replace(cfg, scan_chunk=4),
                           _setup(cfg)[3])
    params, opt_state, state, _ = _setup(cfg)
    pb, ob, sb, rb = eng.run_epoch(params, opt_state, state, iter(batches),
                                   torch.Generator().manual_seed(3), DST,
                                   collect_logits=True)
    _assert_equal(tree_leaves(pa) + tree_leaves(oa) + _flat_state(sa),
                  tree_leaves(pb) + tree_leaves(ob) + _flat_state(sb))
    assert (ra.loss, ra.ap, ra.aps) == (rb.loss, rb.ap, rb.aps)
    assert ra.obs == rb.obs and rb.obs["steps"] == len(batches) - 1
    assert eng.captured is False and eng.eager_reason is None  # the CPU
    g = torch.Generator().manual_seed(3)
    want = torch.stack([sample_negatives(g, b, *DST).dst
                        for b in batches[1:]])
    assert torch.equal(torch.cat(eng.negatives), want)


def test_epoch_step_counts_match_across_engines(tiny_stream):
    """Lag-one, pipelined and scan epochs report K - 1 per-step APs over
    the same batches (chunk 5 over 12 steps: macros of 5, 5 and 2)."""
    batches = _tstream(tiny_stream).temporal_batches(47, "cpu")   # K = 13
    cfg = _cfg(tiny_stream)
    counts = {}
    *_, res = _epoch(cfg, batches, collect_logits=True)
    counts["lag-one"] = len(res.aps)
    pcfg = dataclasses.replace(cfg, pipeline_depth=2)
    params, opt_state, state, opt = _setup(pcfg)
    *_, res = tpipeline.run_epoch(
        params, opt_state, state, iter(batches), pcfg,
        tpipeline.make_train_step(pcfg, opt),
        torch.Generator().manual_seed(3), DST, collect_logits=True)
    counts["pipelined"] = len(res.aps)
    *_, res = _epoch(cfg, batches, chunk=5, collect_logits=True)
    counts["scan"] = len(res.aps)
    assert counts == {n: len(batches) - 1 for n in counts}


def test_injected_negatives_drive_the_macros(tiny_stream):
    """Negatives given per step replace the in-step draws (the route the
    JAX parity below takes): the same epoch as the lag-one loop's with
    those negatives."""
    cfg = _cfg(tiny_stream)
    batches = _tstream(tiny_stream).temporal_batches(100, "cpu")
    g = torch.Generator().manual_seed(11)
    negs = [sample_negatives(g, b, *DST) for b in batches[1:]]
    pa, _, sa, ra = _epoch(cfg, batches, negatives=negs)
    pb, _, sb, rb = _epoch(cfg, batches, chunk=3, negatives=negs)
    _assert_equal(tree_leaves(pa) + _flat_state(sa),
                  tree_leaves(pb) + _flat_state(sb))
    assert ra.loss == rb.loss
    with pytest.raises(ValueError, match="fewer injected"):
        _epoch(cfg, batches, chunk=3, negatives=negs[:2])


# ---------------------------------------------------------------------------
# against JAX's ScanEngine
# ---------------------------------------------------------------------------


def _jstate_np(state):
    return {"memory": {"mem": np.array(state["memory"].mem),
                       "last_update": np.array(state["memory"].last_update)},
            "neighbors": {k: np.array(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.array(state["pres"].n),
                     "xi": np.array(state["pres"].xi),
                     "psi": np.array(state["pres"].psi)}}


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: {err:.3g} > {lim:.3g}"


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "plain"])
def test_scan_chunk4_matches_jax_scan_engine(tiny_stream, use_kernels):
    sub = tiny_stream.slice(0, 500)
    jcfg = jmdgnn.MDGNNConfig(
        variant="tgn", n_nodes=sub.num_nodes, d_edge=sub.feat_dim, d_mem=8,
        d_msg=8, d_time=4, d_embed=8, n_neighbors=4, use_pres=True,
        use_kernels=use_kernels, scan_chunk=4)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jmdgnn.init_state(jcfg)),
                                     "cpu")
    jb = sub.temporal_batches(50)                 # 10 batches: 4, 4, 1
    key = jax.random.PRNGKey(7)
    negs, k = [], key
    for b in jb[1:]:
        k, s = jax.random.split(k)
        negs.append(_tbatch(jsample(s, b, *DST)))
    jparams, _, jstate, jres = jscan.ScanEngine(jcfg, jopt).run_epoch(
        jparams, jopt.init(jparams), jmdgnn.init_state(jcfg), jb, key, DST)
    tparams, _, tstate, tres = tscan.ScanEngine(tcfg, topt).run_epoch(
        tparams, topt.init(tparams), tstate,
        _tstream(sub).temporal_batches(50, "cpu"), None, DST,
        negatives=negs)
    for tp, jp in zip(tree_leaves(tparams),
                      jax.tree.leaves(jax.tree.map(np.array, jparams))):
        _close(tp.detach().numpy(), jp, 1e-5, "parameter")
    a, b = bridge.state_to_numpy(tstate), _jstate_np(jstate)
    for key_ in ("nbr", "t", "ptr"):
        np.testing.assert_array_equal(a["neighbors"][key_],
                                      b["neighbors"][key_])
    np.testing.assert_array_equal(a["memory"]["last_update"],
                                  b["memory"]["last_update"])
    np.testing.assert_array_equal(a["pres"]["n"], b["pres"]["n"])
    _close(a["memory"]["mem"], b["memory"]["mem"], 1e-5, "memory table")
    for key_ in ("xi", "psi"):
        _close(a["pres"][key_], b["pres"][key_], 1e-4, f"tracker {key_}")
    _close(tres.loss, jres.loss, 1e-5, "loss")
    assert abs(tres.ap - jres.ap) <= 1e-3
