"""The port's serving slice against the JAX package on the CPU.

Both engines start from the same parameters (JAX's init, moved through
`repro_torch.bridge`) and fold the same requests; the JAX engine with
use_kernels=True resolves every kernel to its jnp oracle on the CPU, the
port's to its plain PyTorch version. Tolerances: ring buffers, pointers,
last_update and tracker counts exact (integers or copied values); memory
table and xi/psi 1e-5 after one ingest and 1e-4 after a sequence (fp32
sums in another order, accumulated over ingests); scores 1e-4."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.graph import datasets as jdatasets
from repro.models import mdgnn as jmdgnn
from repro.serve import MicroBatcher as JBatcher
from repro.serve import ServeEngine as JEngine
from repro.serve import replay as jreplay

from repro_torch import bridge
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph import events as tevents
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.serve import MicroBatcher, ServeEngine, replay

BUCKETS = (16, 64)


def _jcfg(stream, n_layers=1):
    return jmdgnn.MDGNNConfig(
        variant="tgn", n_nodes=stream.num_nodes, d_edge=stream.feat_dim,
        d_mem=16, d_msg=16, d_time=8, d_embed=16, n_neighbors=4,
        n_layers=n_layers, use_pres=True, use_kernels=True)


def _jstate_np(state):
    return {"memory": {"mem": np.asarray(state["memory"].mem),
                       "last_update": np.asarray(state["memory"].last_update)},
            "neighbors": {k: np.asarray(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.asarray(state["pres"].n),
                     "xi": np.asarray(state["pres"].xi),
                     "psi": np.asarray(state["pres"].psi)}}


def _pair(stream, dst, n_layers=1, buckets=BUCKETS, seed=0):
    jcfg = _jcfg(stream, n_layers)
    params, _ = jmdgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    state = jmdgnn.init_state(jcfg)
    np_params = jax.tree.map(np.asarray, params)
    np_state = _jstate_np(state)
    je = JEngine(jcfg, params, state, item_range=dst,
                 batcher=JBatcher(buckets=buckets, d_edge=jcfg.d_edge))
    te = ServeEngine(tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg)),
                     bridge.params_from_numpy(np_params, "cpu"),
                     bridge.state_from_numpy(np_state, "cpu"),
                     item_range=dst, device="cpu",
                     batcher=MicroBatcher(buckets=buckets,
                                          d_edge=jcfg.d_edge))
    return je, te


def _assert_state(je, te, tol):
    js = _jstate_np(je.state)
    ts = bridge.state_to_numpy(te.state)
    for k in ("nbr", "t", "ptr"):
        np.testing.assert_array_equal(ts["neighbors"][k], js["neighbors"][k])
    np.testing.assert_array_equal(ts["memory"]["last_update"],
                                  js["memory"]["last_update"])
    np.testing.assert_array_equal(ts["pres"]["n"], js["pres"]["n"])
    np.testing.assert_allclose(ts["memory"]["mem"], js["memory"]["mem"],
                               atol=tol, rtol=0)
    for k in ("xi", "psi"):
        np.testing.assert_allclose(ts["pres"][k], js["pres"][k], atol=tol,
                                   rtol=0)


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_serve_slice_matches_jax(tiny_stream, tiny_spec, n_layers):
    dst = _dst(tiny_spec)
    je, te = _pair(tiny_stream, dst, n_layers)
    je.warmup(topk_k=3)
    te.warmup(topk_k=3)
    _assert_state(je, te, 0.0)
    s, d, t, f = (tiny_stream.src, tiny_stream.dst, tiny_stream.t,
                  tiny_stream.feat)
    lo = 0
    for i, n in enumerate((40, 3, 17, 64, 100, 5)):
        je.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        te.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        lo += n
        _assert_state(je, te, 1e-5 if i == 0 else 1e-4)
    q = slice(lo, lo + 30)
    np.testing.assert_allclose(te.query(s[q], d[q], t[q]),
                               je.query(s[q], d[q], t[q]), atol=1e-4, rtol=0)
    srcs, ts = s[lo:lo + 4], t[lo:lo + 4]
    jv, ji = je.recommend_topk(srcs, ts, 5)
    tv, ti = te.recommend_topk(srcs, ts, 5)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-4, rtol=0)
    jv = np.asarray(jv)
    for r, j in zip(*np.nonzero(ti != np.asarray(ji))):
        # ids may differ only between items whose scores tie within 1e-4
        gaps = [abs(jv[r, j] - jv[r, j + o]) for o in (-1, 1)
                if 0 <= j + o < jv.shape[1]]
        assert min(gaps) <= 1e-4, (r, j, jv[r])


def test_ingest_pad_invariant(tiny_stream, tiny_spec):
    """The same requests padded to bucket 32 or 128 leave the same state."""
    dst = _dst(tiny_spec)
    _, e1 = _pair(tiny_stream, dst, buckets=(32,))
    _, e2 = _pair(tiny_stream, dst, buckets=(128,))
    s, d, t, f = (tiny_stream.src, tiny_stream.dst, tiny_stream.t,
                  tiny_stream.feat)
    for lo in range(0, 90, 32):
        e1.ingest(s[lo:lo + 32], d[lo:lo + 32], t[lo:lo + 32], f[lo:lo + 32])
        e2.ingest(s[lo:lo + 32], d[lo:lo + 32], t[lo:lo + 32], f[lo:lo + 32])
    a, b = bridge.state_to_numpy(e1.state), bridge.state_to_numpy(e2.state)
    for part in a:
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k])


def test_warmup_is_noop_after_traffic(tiny_stream, tiny_spec):
    dst = _dst(tiny_spec)
    _, te = _pair(tiny_stream, dst)
    te.ingest(tiny_stream.src[:50], tiny_stream.dst[:50], tiny_stream.t[:50],
              tiny_stream.feat[:50])
    before = bridge.state_to_numpy(te.state)
    te.warmup(topk_k=3)
    after = bridge.state_to_numpy(te.state)
    for part in before:
        for k in before[part]:
            np.testing.assert_array_equal(before[part][k], after[part][k])


def test_replay_online_ap_matches_jax(tiny_stream, tiny_spec):
    dst = _dst(tiny_spec)
    je, te = _pair(tiny_stream, dst)
    kw = dict(rate=20000.0, tick=0.004, query_batch=8, max_events=300,
              seed=0, late_frac=0.1, max_late=20)
    jr = jreplay(je, tiny_stream, dst, **kw)
    tr = replay(te, tiny_stream, dst, **kw)
    assert (tr.n_events, tr.n_queries, tr.n_ticks) == (
        jr.n_events, jr.n_queries, jr.n_ticks)
    assert abs(tr.online_ap - jr.online_ap) <= 1e-6


@pytest.mark.parametrize("name", ["tiny", "wiki-small"])
def test_generate_byte_identical(name, tiny_spec):
    if name == "tiny":
        jspec = tiny_spec
        tspec = tdatasets.SyntheticSpec(**dataclasses.asdict(tiny_spec))
    else:
        jspec, tspec = jdatasets.SPECS[name], tdatasets.SPECS[name]
    a, b = jdatasets.generate(jspec, seed=3), tdatasets.generate(tspec, seed=3)
    for col in ("src", "dst", "t", "feat"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col
    assert a.num_nodes == b.num_nodes


def test_metrics_match_jax():
    from repro.utils import metrics as jmetrics
    from repro_torch.utils import metrics as tmetrics
    rng = np.random.default_rng(0)
    pos = np.round(rng.normal(0.5, 1, 300), 1)      # rounded: many ties
    neg = np.round(rng.normal(0.0, 1, 400), 1)
    assert tmetrics.average_precision(pos, neg) == \
        jmetrics.average_precision(pos, neg)
    assert tmetrics.roc_auc(pos, neg) == jmetrics.roc_auc(pos, neg)


@pytest.mark.parametrize("lo,hi", [(0, 3000), (123_457, 125_000)])
def test_stream_chunk_byte_identical(lo, hi):
    a = jdatasets.stream_chunk(jdatasets.STREAM_SPECS["stream-small"], 7,
                               lo, hi)
    b = tdatasets.stream_chunk(tdatasets.STREAM_SPECS["stream-small"], 7,
                               lo, hi)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_unsupported_config_names_roadmap_item(tiny_stream):
    cfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(_jcfg(tiny_stream)))
    # values no slice defines: a named ValueError
    for change in (dict(mem_dtype="float16"), dict(n_shards=0),
                   dict(shard_budget=0)):
        with pytest.raises(ValueError, match="mem_dtype|n_shards|budget"):
            tmdgnn.check_supported(dataclasses.replace(cfg, **change))
    # ported by the tenth slice, (scan, the store, telemetry) the
    # fourteenth and (memory parallelism, bf16 tables) the fifteenth:
    # accepted
    for change in (dict(variant="jodie"), dict(pres_buckets=8),
                   dict(anchor_fraction=0.5), dict(use_kernels=False),
                   dict(scan_chunk=2), dict(event_store="x"),
                   dict(obs_metrics=True), dict(mem_dtype="bfloat16"),
                   dict(n_shards=2), dict(shard_budget=64)):
        tmdgnn.check_supported(dataclasses.replace(cfg, **change))
    state = tmdgnn.init_state(cfg, "cpu")
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="interpret"):
        ServeEngine(dataclasses.replace(cfg, kernels_mode="interpret"),
                    params, state, device="cpu").query([0], [1], [1.0])


@pytest.mark.parametrize("model", ["apan", "tgn", "jodie"])
def test_launch_serve_cli_on_cpu(model, capsys):
    """The serve CLI's replay and top-k on the CPU, APAN, TGN and JODIE."""
    from repro_torch.launch import serve as tserve
    rep = tserve.main(["--dataset", "wiki-small", "--model", model,
                       "--pres", "--use-kernels", "--device", "cpu",
                       "--d-mem", "8", "--max-events", "400", "--topk", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {model}-PRES" in out and "topk  : k=3" in out
    assert rep.n_events == 400 and 0.0 <= rep.online_ap <= 1.0


def test_launch_serve_cli_refuses_unported_flags(tmp_path, tiny_stream,
                                                 capsys):
    """The flags of the fourteenth slice (--event-store, --trace-dir,
    --metrics-out) now serve; a sharded configuration is refused by the
    engine with a named error (serving has no sharded path, as in JAX)."""
    from repro_torch.graph import store as tstore
    from repro_torch.launch import serve as tserve
    tstore.write_stream(tevents.EventStream(
        tiny_stream.src, tiny_stream.dst, tiny_stream.t, tiny_stream.feat,
        tiny_stream.num_nodes), tmp_path / "store",
        meta={"n_users": 50, "n_items": 30})
    rep = tserve.main(["--pres", "--use-kernels", "--device", "cpu",
                       "--d-mem", "8", "--serve-frac", "0.5",
                       "--event-store", str(tmp_path / "store"),
                       "--trace-dir", str(tmp_path / "tr"),
                       "--trace-steps", "2",
                       "--metrics-out", str(tmp_path / "run.jsonl")])
    out = capsys.readouterr().out
    assert f"store {tmp_path / 'store'}" in out and rep.n_events == 300
    assert (tmp_path / "tr" / "trace.json").is_file()
    assert (tmp_path / "run.jsonl").read_text().count('"kind": "serve"') == 1
    cfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(_jcfg(tiny_stream)))
    with pytest.raises(ValueError, match="no sharded path"):
        ServeEngine(dataclasses.replace(cfg, n_shards=2),
                    tmdgnn.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu"),
                    tmdgnn.init_state(cfg, "cpu"), device="cpu")
