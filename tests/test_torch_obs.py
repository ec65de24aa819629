"""The port's telemetry layer (repro_torch.obs) against the JAX package's
on the CPU.

Tolerances: 1e-6 (relative to max(1, |value|)) for fp32 statistics
computed from the same inputs (pres_delta_stats, gmm_health); the per-step
obs series of a 3-step training epoch 1e-5 relative for the values that
training moves (loss, coherence cosine, the PRES delta stats: the port's
and JAX's steps agree to that, tests/test_torch_train.py), exact for the
counts (events, written rows, staleness); exact for histograms, bucket
edges, digests and file contents."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.graph.negatives import sample_negatives as jsample
from repro.models import mdgnn as jmdgnn
from repro.obs import metrics as jobs
from repro.obs import sink as jsink
from repro.optim import optimizers as joptim
from repro.train import loop as jloop
from repro.train import pipeline as jpipeline

from repro_torch import bridge
from repro_torch.graph import events as tevents
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.obs import metrics as tobs
from repro_torch.obs import sink as tsink
from repro_torch.obs import trace as ttrace
from repro_torch.optim import optimizers as toptim
from repro_torch.serve import MicroBatcher, ServeEngine, replay
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline

B = 100
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jcfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
                d_embed=16, n_neighbors=4, use_pres=True, use_kernels=True,
                obs_metrics=True)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _tcfg(jcfg):
    return tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = tol * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= lim), f"{what}: {got} vs {want}"


def _jstate_np(state):
    return {"memory": {"mem": np.array(state["memory"].mem),
                       "last_update": np.array(state["memory"].last_update)},
            "neighbors": {k: np.array(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.array(state["pres"].n),
                     "xi": np.array(state["pres"].xi),
                     "psi": np.array(state["pres"].psi)}}


def _tinit(tcfg, seed=0):
    params = tmdgnn.init_params(tcfg, torch.Generator().manual_seed(seed),
                                "cpu")
    opt = toptim.adamw(1e-3)
    return params, opt, opt.init(params), tmdgnn.init_state(tcfg, "cpu")


# ---------------------------------------------------------------------------
# the obs vector
# ---------------------------------------------------------------------------


def test_pack_unpack_roundtrip_matches_jax():
    kw = dict(loss=0.5, coherence_cos=0.9, pres_delta_mean=0.1, events=64.0)
    vec = tobs.pack_train_obs(**kw)
    assert tobs.TRAIN_OBS_FIELDS == jobs.TRAIN_OBS_FIELDS
    assert vec.shape == (len(tobs.TRAIN_OBS_FIELDS),)
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(jobs.pack_train_obs(**kw)))
    series = tobs.unpack_series(vec.numpy())
    assert series == jobs.unpack_series(np.asarray(vec.numpy()))
    assert series["loss"] == [0.5] and series["staleness"] == [0.0]
    # tensors keep their device and value; python numbers become fills
    t = tobs.pack_train_obs(loss=torch.tensor(0.25), staleness=2)
    assert t[0] == 0.25 and t[tobs.TRAIN_OBS_FIELDS.index("staleness")] == 2


def test_pack_rejects_unknown_field():
    with pytest.raises(KeyError, match="unknown obs field"):
        tobs.pack_train_obs(losss=0.5)


def test_pres_delta_stats_masked_matches_jax():
    rng = np.random.default_rng(0)
    s_pred = rng.normal(size=(64, 16)).astype(np.float32)
    s_meas = rng.normal(size=(64, 16)).astype(np.float32)
    written = rng.random(64) < 0.6
    got = tobs.pres_delta_stats(torch.from_numpy(s_pred),
                                torch.from_numpy(s_meas),
                                torch.from_numpy(written))
    want = jobs.pres_delta_stats(jnp.asarray(s_pred), jnp.asarray(s_meas),
                                 jnp.asarray(written))
    _close([float(x) for x in got[:2]], [float(x) for x in want[:2]], 1e-6,
           "delta mean/max")
    assert float(got[2]) == float(want[2]) == float(written.sum())
    zero = tobs.pres_delta_stats(torch.from_numpy(s_pred),
                                 torch.from_numpy(s_meas),
                                 torch.zeros(64, dtype=torch.bool))
    assert [float(x) for x in zero] == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# latency histograms
# ---------------------------------------------------------------------------


def test_latency_hist_and_percentiles_match_jax():
    rng = np.random.default_rng(1)
    secs = np.concatenate([rng.exponential(0.002, 500), [1e-9, 50.0]])
    np.testing.assert_array_equal(tobs.LATENCY_EDGES_MS,
                                  jobs.LATENCY_EDGES_MS)
    for edges in (tobs.LATENCY_EDGES_MS, tobs.log_bucket_edges(1.0, 1e3, 3)):
        got = tobs.latency_hist(secs, edges_ms=edges)
        want = jobs.latency_hist(secs, edges_ms=edges)
        assert got == want
        assert sum(got["counts"]) == got["n"] == len(secs)
        for q in (50, 90, 99, 100):
            assert tobs.hist_percentile(got, q) == \
                jobs.hist_percentile(want, q)
    for lo, hi, n in ((0.0, 1.0, 4), (1.0, 1.0, 4), (1.0, 2.0, 0)):
        with pytest.raises(ValueError):
            tobs.log_bucket_edges(lo, hi, n)
    assert tobs.hist_percentile({"edges_ms": [1.0, 2.0], "counts": [0]},
                                99) == 0.0


def test_replay_reports_full_histograms(tiny_stream, tiny_spec):
    dst = _dst(tiny_spec)
    cfg = _tcfg(_jcfg(tiny_stream, obs_metrics=False))
    params, _, _, state = _tinit(cfg)
    eng = ServeEngine(cfg, params, state, item_range=dst, device="cpu",
                      batcher=MicroBatcher(buckets=(16, 64),
                                           d_edge=tiny_stream.feat_dim))
    rep = replay(eng, _tstream(tiny_stream), dst, rate=20000.0, tick=0.004,
                 query_batch=8, max_events=200, seed=0)
    for hist in (rep.ingest_hist, rep.query_hist):
        assert hist["n"] == rep.n_ticks == sum(hist["counts"])
        assert len(hist["counts"]) == len(hist["edges_ms"]) - 1
    assert rep.ingest_p50_ms <= tobs.hist_percentile(rep.ingest_hist, 50)


# ---------------------------------------------------------------------------
# EpochObs and the zero-sync contract
# ---------------------------------------------------------------------------


def test_epoch_obs_per_step_and_stacked():
    assert tobs.EpochObs().finish() == (0, None)
    eo = tobs.EpochObs()
    for i in range(3):
        m = {"obs": tobs.pack_train_obs(loss=float(i), events=10.0)}
        eo.step(m)
        assert "obs" not in m                 # popped
    before = tobs.host_fetches()
    total, out = eo.finish()
    assert tobs.host_fetches() == before + 1
    assert total == 0 and out["steps"] == 3
    assert out["series"]["loss"] == [0.0, 1.0, 2.0]
    assert out["series"]["events"] == [10.0] * 3
    # a scan emits (T, F) stacks a macro; a ragged tail concatenates
    eo = tobs.EpochObs()
    for t, base in ((3, 0.0), (2, 3.0)):
        eo.step({"obs": torch.stack([tobs.pack_train_obs(loss=base + i)
                                     for i in range(t)])})
    _, out = eo.finish()
    assert out["steps"] == 5
    assert out["series"]["loss"] == [0.0, 1.0, 2.0, 3.0, 4.0]


def _port_epoch(stream, spec, obs_on, seed=3):
    cfg = _tcfg(_jcfg(stream, obs_metrics=obs_on))
    params, opt, opt_state, state = _tinit(cfg)
    batches = _tstream(stream).temporal_batches(B, "cpu")
    before = tobs.host_fetches()
    *_, res = tloop.run_epoch(params, opt_state, state, batches, cfg,
                              tloop.make_train_step(cfg, opt),
                              torch.Generator().manual_seed(seed),
                              _dst(spec))
    return tobs.host_fetches() - before, res


def test_zero_sync_contract(tiny_stream, tiny_spec):
    """With telemetry on the epoch makes exactly one more fetch (the
    flush), whatever the step count, and observing changes no number."""
    f_off, off = _port_epoch(tiny_stream, tiny_spec, False)
    f_on, on = _port_epoch(tiny_stream, tiny_spec, True)
    assert (f_off, f_on) == (0, 1)
    assert off.obs is None
    n_steps = tiny_stream.num_batches(B) - 1
    assert on.obs["steps"] == n_steps
    assert all(len(v) == n_steps for v in on.obs["series"].values())
    assert on.loss == off.loss and on.ap == off.ap
    assert np.mean(on.obs["series"]["loss"]) == pytest.approx(on.loss,
                                                               abs=1e-6)
    assert max(on.obs["series"]["staleness"]) == 0.0
    assert on.obs["series"]["pres_delta_events"][-1] > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_obs_series_match_jax(tiny_stream, tiny_spec, depth):
    """The obs series of a 3-step Alg. 2 epoch, lag-one and pipelined at
    depth 2 (whose staleness cycles 1, 2, 1), against JAX's with JAX's
    negatives injected."""
    jcfg = _jcfg(tiny_stream, pipeline_depth=depth)
    tcfg = _tcfg(jcfg)
    dst = _dst(tiny_spec)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    tparams = bridge.params_from_numpy(
        jax.tree.map(np.array, jparams), "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jmdgnn.init_state(jcfg)),
                                     "cpu")
    sub = tiny_stream.slice(0, 4 * B)
    jb = sub.temporal_batches(B)
    key = jax.random.PRNGKey(5)
    negs, k = [], key
    for b in jb[1:]:
        k, s = jax.random.split(k)
        negs.append(_tbatch(jsample(s, b, *dst)))
    *_, jres = jpipeline.run_epoch(
        jparams, jopt.init(jparams), jmdgnn.init_state(jcfg), jb, jcfg,
        jpipeline.make_train_step(jcfg, jopt), key, dst)
    *_, tres = tpipeline.run_epoch(
        tparams, topt.init(tparams), tstate,
        _tstream(sub).temporal_batches(B, "cpu"), tcfg,
        tpipeline.make_train_step(tcfg, topt), None, dst, negatives=negs)
    got, want = tres.obs["series"], jres.obs["series"]
    assert tres.obs["steps"] == jres.obs["steps"] == 3
    assert got.keys() == want.keys()
    for f in ("events", "pres_delta_events", "staleness"):
        assert got[f] == want[f], f
    for f in ("loss", "coherence_cos", "pres_delta_mean", "pres_delta_max"):
        _close(got[f], want[f], 1e-5, f)
    assert got["staleness"] == ([1.0, 2.0, 1.0] if depth else [0.0] * 3)


def test_gmm_health_matches_jax(tiny_stream, tiny_spec):
    """The probe on the same trackers (a JAX epoch's, moved to the
    port)."""
    jcfg = _jcfg(tiny_stream)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = joptim.adamw(1e-3)
    _, _, jstate, _ = jloop.run_epoch(
        jparams, jopt.init(jparams), jmdgnn.init_state(jcfg),
        tiny_stream.temporal_batches(B), jcfg,
        jloop.make_train_step(jcfg, jopt), jax.random.PRNGKey(0),
        _dst(tiny_spec))
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    got = tobs.gmm_health(tstate["pres"])
    want = jobs.gmm_health(jstate["pres"])
    assert got.keys() == want.keys()
    _close([got[k] for k in want], [want[k] for k in want], 1e-6,
           "gmm_health")
    assert 0.0 < got["tracked_fraction"] <= 1.0 and got["observations"] > 0


# ---------------------------------------------------------------------------
# the sink
# ---------------------------------------------------------------------------


def test_runlog_roundtrip_and_rejects(tmp_path, tiny_stream):
    path = tmp_path / "run.jsonl"
    cfg = _tcfg(_jcfg(tiny_stream))
    with tsink.RunLog(path, role="train", cfg=cfg, argv=["--x"]) as log:
        log.write("epoch", epoch=0, loss=np.float32(0.5),
                  series={"loss": np.asarray([0.5, 0.4])},
                  t=torch.tensor([1.0, 2.0]))
    records = tsink.read_runlog(path)
    assert records == jsink.read_runlog(path)    # JAX's reader, same schema
    man = records[0]
    assert man["schema_version"] == tsink.SCHEMA_VERSION \
        == jsink.SCHEMA_VERSION
    assert man["role"] == "train" and man["argv"] == ["--x"]
    assert man["obs_fields"] == list(jobs.TRAIN_OBS_FIELDS)
    assert man["meta"]["cfg_digest"] == tsink.cfg_digest(cfg)
    assert man["meta"]["backend"] == "cpu" and "torch" in man["meta"]
    assert man["cfg"]["obs_metrics"] is True
    ep = [r for r in records if r["kind"] == "epoch"][0]
    assert ep["loss"] == 0.5 and ep["t"] == [1.0, 2.0]
    assert records[-1]["kind"] == "end"
    with pytest.raises(ValueError, match="closed"):
        log.write("epoch", epoch=1)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    with pytest.raises(ValueError, match="not JSONL"):
        tsink.read_runlog(bad)
    bad.write_text(json.dumps({"kind": "epoch"}) + "\n")
    with pytest.raises(ValueError, match="manifest"):
        tsink.read_runlog(bad)
    bad.write_text(json.dumps({"kind": "manifest", "schema_version": 9})
                   + "\n")
    with pytest.raises(ValueError, match="schema_version"):
        tsink.read_runlog(bad)


def test_canonical_equal_for_two_deterministic_runs(tmp_path, tiny_stream,
                                                    tiny_spec):
    from repro_torch.kernels import ops as kops
    paths = []
    for name in ("a", "b"):
        # the dispatch table counts every call of the process (JAX's, once
        # a trace): each run-log's table covers its own run
        kops.reset_dispatch_log()
        _, res = _port_epoch(tiny_stream, tiny_spec, True, seed=7)
        paths.append(tmp_path / f"{name}.jsonl")
        with tsink.RunLog(paths[-1], role="train",
                          cfg=_tcfg(_jcfg(tiny_stream)), argv=[]) as log:
            log.write("epoch", epoch=0, loss=res.loss, seconds=res.seconds,
                      steps=res.obs["steps"], series=res.obs["series"])
    a, b = (tsink.canonical(tsink.read_runlog(p)) for p in paths)
    assert a == b
    assert tsink.canonical(tsink.read_runlog(paths[0])) == \
        jsink.canonical(jsink.read_runlog(paths[0]))
    assert "t_start" not in a[0] and "seconds" not in a[1]


def test_cfg_digest_matches_jax(tiny_stream):
    for kw in ({}, {"d_mem": 32, "d_msg": 32, "d_embed": 32},
               {"scan_chunk": 4, "event_store": "x"}):
        jcfg = _jcfg(tiny_stream, **kw)
        assert tsink.cfg_digest(_tcfg(jcfg)) == jsink.cfg_digest(jcfg)
    assert tsink.cfg_digest(_tcfg(_jcfg(tiny_stream))) != \
        tsink.cfg_digest(_tcfg(_jcfg(tiny_stream, d_mem=32)))


# ---------------------------------------------------------------------------
# spans and the profiler window
# ---------------------------------------------------------------------------


def test_spans_off_by_default_and_prefetch_wait_recorded(tiny_stream):
    ttrace.drain()
    with ttrace.span("noop"):
        pass
    assert ttrace.drain() == []
    stream = _tstream(tiny_stream)
    list(stream.prefetch_batches(B, "cpu"))
    assert ttrace.drain() == []
    ttrace.enable()
    try:
        n = len(list(stream.prefetch_batches(B, "cpu")))
        spans = ttrace.drain()
    finally:
        ttrace.disable()
    names = [s["name"] for s in spans]
    assert names == ["prefetch_wait"] * (n + 1)   # each next() and the end
    summ = ttrace.span_summary(spans)
    assert summ["prefetch_wait"]["count"] == n + 1
    assert summ["prefetch_wait"]["total_s"] >= 0.0
    assert ttrace.drain() == []


def test_step_trace_capture_writes_a_trace(tmp_path):
    tracer = ttrace.StepTraceCapture(str(tmp_path / "tr"), n_steps=2)
    step = tracer.wrap(lambda x: x * 2)
    assert [step(torch.ones(3)).sum().item() for _ in range(3)] == [6.0] * 3
    tracer.stop()
    events = json.loads(tracer.path.read_text())["traceEvents"]
    assert sum(e.get("name") == "step#0" for e in events) == 1
    assert not any(e.get("name") == "step#2" for e in events)
    with pytest.raises(ValueError):
        ttrace.StepTraceCapture(str(tmp_path), n_steps=0)


# ---------------------------------------------------------------------------
# the CLI's run-log through JAX's inspector
# ---------------------------------------------------------------------------


def _load_inspector():
    spec = importlib.util.spec_from_file_location(
        "inspect_run", ROOT / "tools" / "inspect_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inspector_renders_port_cli_runlog(tmp_path, capsys):
    """The port's train and serve CLIs on the CPU write run-logs that the
    JAX package's tools/inspect_run.py renders."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    small = ["--dataset", "mooc-small", "--pres", "--use-kernels",
             "--device", "cpu", "--d-mem", "8"]
    ttrain.main(small + ["--batch-size", "2000", "--epochs", "1",
                         "--pipeline-depth", "2", "--metrics-out",
                         str(tmp_path / "train.jsonl")])
    tserve.main(small + ["--max-events", "300", "--metrics-out",
                         str(tmp_path / "serve.jsonl")])
    capsys.readouterr()
    inspect_run = _load_inspector()
    assert inspect_run.main([str(tmp_path / "train.jsonl")]) == 0
    report = capsys.readouterr().out
    for needle in ("Run report", "PRES prediction error",
                   "Memory-coherence cosine", "Pipeline staleness",
                   "GMM tracker health", "Host spans", "prefetch_wait",
                   "Kernel dispatch", "memory_update_table"):
        assert needle in report, needle
    assert inspect_run.main([str(tmp_path / "serve.jsonl")]) == 0
    report = capsys.readouterr().out
    for needle in ("Serve replay", "Ingest latency", "Query latency",
                   "Kernel dispatch"):
        assert needle in report, needle
