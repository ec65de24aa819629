"""The port's on-disk event store and CSR index (repro_torch.graph.store,
repro_torch.graph.csr) on the CPU, against the JAX package's.

Everything here is exact: the two packages write the same file bytes (a
store written by either opens in the other), the port's windows and
batches equal the in-RAM carve bit for bit at any window size, and an
epoch from a store leaves the same bits in every parameter and state
tensor as the epoch from RAM, on every engine."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

from repro.graph import csr as jcsr
from repro.graph import datasets as jdatasets
from repro.graph import store as jstore

from repro_torch.graph import csr as tcsr
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph import events as tevents
from repro_torch.graph import store as tstore
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline
from repro_torch.train import scan as tscan
from repro_torch.utils.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parent.parent
DST = (50, 80)                   # tiny_stream's item band
META = {"n_users": 50, "n_items": 30}


@pytest.fixture
def ram(tiny_stream):
    s = tiny_stream
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _store(tmp_path, stream, name="store", chunk=200, lib=tstore):
    return lib.write_stream(stream, tmp_path / name, chunk_events=chunk,
                            meta=META)


def _files(path) -> dict:
    """Every file of a store (or index) directory by name, its bytes; the
    header parsed (its JSON layout is not part of the format)."""
    out = {}
    for p in sorted(pathlib.Path(path).iterdir()):
        if p.is_file():
            out[p.name] = (json.loads(p.read_text()) if p.suffix == ".json"
                           else p.read_bytes())
    return out


def _assert_streams_equal(a, b):
    for f in ("src", "dst", "t", "feat"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("src", "dst", "t", "feat", "mask"):
            assert torch.equal(getattr(g, f), getattr(w, f)), f


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------


def test_roundtrip_columns_and_chunk_invariance(tmp_path, ram):
    store = _store(tmp_path, ram)
    assert (store.n_events, store.num_nodes, store.feat_dim) == (
        len(ram), ram.num_nodes, ram.feat_dim)
    assert store.nbytes == store.n_events * (12 + 4 * store.feat_dim)
    _assert_streams_equal(store.stream(), ram)
    _assert_streams_equal(store.window(0), ram)
    other = _store(tmp_path, ram, "b", chunk=len(ram))
    assert _files(store.path) == _files(other.path)
    assert store.dst_range() == DST
    assert tstore.write_stream(ram, tmp_path / "bare").dst_range() == (
        0, ram.num_nodes)


def test_stores_open_in_both_packages(tmp_path, tiny_stream, ram):
    """A JAX-written store opens in the port and a port-written one in
    JAX, the files byte-equal, the columns equal."""
    mine = _store(tmp_path, ram, "port", chunk=97)
    theirs = _store(tmp_path, tiny_stream, "jax", chunk=131, lib=jstore)
    assert _files(mine.path) == _files(theirs.path)
    a = tstore.EventStore.open(theirs.path)
    b = jstore.EventStore.open(mine.path)
    assert (a.n_events, a.num_nodes, a.feat_dim, a.meta) == (
        b.n_events, b.num_nodes, b.feat_dim, b.meta)
    _assert_streams_equal(a.stream(), tiny_stream)
    _assert_streams_equal(b.stream(), ram)


def test_writer_validation_and_bad_stores(tmp_path, ram):
    s = ram
    with pytest.raises(ValueError, match="feat_dim"):
        tstore.StoreWriter(tmp_path / "x", num_nodes=10, feat_dim=0)
    with tstore.StoreWriter(tmp_path / "w", num_nodes=s.num_nodes,
                            feat_dim=s.feat_dim) as w:
        with pytest.raises(ValueError, match="ragged"):
            w.append(s.src[:5], s.dst[:4], s.t[:5], s.feat[:5])
        with pytest.raises(ValueError, match="feat must be"):
            w.append(s.src[:5], s.dst[:5], s.t[:5], s.feat[:5, :-1])
        with pytest.raises(ValueError, match="num_nodes"):
            w.append(np.full(3, s.num_nodes, np.int32), s.dst[:3], s.t[:3],
                     s.feat[:3])
        w.append(s.src[:5], s.dst[:5], s.t[:5], s.feat[:5])
        with pytest.raises(ValueError, match="chronological"):
            w.append(s.src[:5], s.dst[:5], s.t[:5] - 100.0, s.feat[:5])
    with pytest.raises(FileNotFoundError, match="not an event store"):
        tstore.EventStore.open(tmp_path / "nope")
    store = _store(tmp_path, ram)
    hdr = json.loads((store.path / tstore.HEADER_NAME).read_text())
    for patch, err in (({"magic": "junk"}, "bad magic"),
                       ({"version": 99}, "unsupported store version"),
                       ({"n_events": 17}, "truncated or mismatched")):
        (store.path / tstore.HEADER_NAME).write_text(
            json.dumps({**hdr, **patch}))
        with pytest.raises(ValueError, match=err):
            tstore.EventStore.open(store.path)
    # an interrupted writer leaves no header, so nothing opens it
    with pytest.raises(RuntimeError):
        with tstore.StoreWriter(tmp_path / "crash", num_nodes=s.num_nodes,
                                feat_dim=s.feat_dim) as w:
            w.append(s.src[:5], s.dst[:5], s.t[:5], s.feat[:5])
            raise RuntimeError("boom")
    assert not (tmp_path / "crash" / tstore.HEADER_NAME).exists()
    with pytest.raises(IndexError):
        store.map_column("src", 5, 2)


# ---------------------------------------------------------------------------
# windows, batches and splits
# ---------------------------------------------------------------------------


def test_slice_matches_inram(tmp_path, ram):
    stream = _store(tmp_path, ram).stream(window_events=64)
    for lo, hi in [(0, 600), (0, 0), (17, 17), (3, 451), (599, 600),
                   (-5, 1000), (300, 200), (550, 9999)]:
        got = stream.slice(lo, hi)
        clo = max(0, min(lo, 600))
        want = ram.slice(clo, max(clo, min(hi, 600)))
        assert len(got) == len(want)
        _assert_streams_equal(got, want)
        _assert_streams_equal(got.slice(2, 11), want.slice(2, 11))
    got = stream.materialize(chunk_events=123)
    assert type(got) is tevents.EventStream
    _assert_streams_equal(got, ram)


@pytest.mark.parametrize("window_events", [64, 77, 150, 600, 100_000])
def test_batch_parity_any_window(tmp_path, ram, window_events):
    store = _store(tmp_path, ram)
    for b in (50, 77):
        _assert_batches_equal(
            store.stream(window_events).iter_temporal_batches(b, "cpu"),
            ram.iter_temporal_batches(b, "cpu"))
    _assert_batches_equal(
        store.stream(window_events).prefetch_batches(50, "cpu"),
        ram.temporal_batches(50, "cpu"))


def test_split_parity(tmp_path, ram):
    stream = _store(tmp_path, ram).stream()
    for got, want in zip(stream.chronological_split(),
                         ram.chronological_split()):
        _assert_streams_equal(got, want)
    for got, want in zip(stream.train_serve_split(0.3),
                         ram.train_serve_split(0.3)):
        _assert_streams_equal(got, want)


# ---------------------------------------------------------------------------
# an epoch from the store
# ---------------------------------------------------------------------------


def _epoch(engine, stream, cfg_kw, batches):
    cfg = tmdgnn.MDGNNConfig(
        variant=cfg_kw.pop("variant", "tgn"), n_nodes=stream.num_nodes,
        d_edge=stream.feat_dim, d_mem=8, d_msg=8, d_time=4, d_embed=8,
        n_neighbors=4, use_pres=True, use_kernels=True, **cfg_kw)
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = toptim.adamw(1e-3)
    carry = (params, opt.init(params), tmdgnn.init_state(cfg, "cpu"))
    gen = torch.Generator().manual_seed(1)
    if engine == "scan":
        return tscan.ScanEngine(cfg, opt).run_epoch(*carry, batches, gen,
                                                    DST)
    return tpipeline.run_epoch(*carry, batches, cfg,
                               tpipeline.make_train_step(cfg, opt), gen, DST)


@pytest.mark.parametrize("engine,cfg_kw", [
    ("lag-one", {}), ("pipelined", {"pipeline_depth": 2}),
    ("scan", {"scan_chunk": 4}), ("lag-one", {"variant": "apan"})],
    ids=["lag-one", "pipelined", "scan", "apan"])
def test_epoch_from_store_bit_identical(tmp_path, ram, engine, cfg_kw):
    store = _store(tmp_path, ram)
    ref = _epoch(engine, ram, dict(cfg_kw), ram.temporal_batches(50, "cpu"))
    got = _epoch(engine, ram, dict(cfg_kw),
                 store.stream(97).prefetch_batches(50, "cpu"))
    assert (got[3].loss, got[3].ap) == (ref[3].loss, ref[3].ap)
    leaves = lambda r: (tree_leaves(r[0]) + tree_leaves(r[1])
                        + tscan._state_leaves(r[2]))
    for a, b in zip(leaves(got), leaves(ref)):
        assert torch.equal(a, b)
    if cfg_kw.get("variant") == "apan":
        assert "mailbox" in got[2]


# ---------------------------------------------------------------------------
# the generator, the index and the converter
# ---------------------------------------------------------------------------


def test_write_stream_spec_matches_jax(tmp_path):
    spec = jdatasets.StreamSpec("gen-test", 1_000, 200, 20_000, 4)
    tspec = tdatasets.StreamSpec(**dataclasses.asdict(spec))
    want = jdatasets.write_stream_spec(spec, tmp_path / "jax", seed=5,
                                       chunk_events=4_096)
    for chunk in (20_000, 777):
        got = tdatasets.write_stream_spec(tspec, tmp_path / f"p{chunk}",
                                          seed=5, chunk_events=chunk)
        assert _files(got.path) == _files(want.path)
    # a prefix: the first events of the same stream, the node space kept
    cut = tdatasets.write_stream_spec(tspec, tmp_path / "cut", seed=5,
                                      chunk_events=999, n_events=5_000)
    assert (cut.n_events, cut.num_nodes) == (5_000, 1_200)
    _assert_streams_equal(cut.stream(), want.window(0, 5_000))


def _brute_neighbors(stream, node):
    out = []
    for e in range(len(stream)):
        if stream.src[e] == node:
            out.append((stream.dst[e], stream.t[e], e))
        if stream.dst[e] == node:
            out.append((stream.src[e], stream.t[e], e))
    return out


def test_csr_against_brute_force_and_jax(tmp_path, tiny_stream, ram):
    index = tcsr.build_csr(ram, chunk_events=113)
    assert index.nnz == 2 * len(ram)
    for node in (0, 3, 49, 50, 79):
        want = _brute_neighbors(ram, node)
        nbr, ts, eid = index.neighbors(node)
        assert index.degree(node) == len(want)
        np.testing.assert_array_equal(nbr, [w[0] for w in want])
        np.testing.assert_array_equal(ts, [w[1] for w in want])
        np.testing.assert_array_equal(eid, [w[2] for w in want])
        rn, _, re_ = index.recent(node, 3)
        np.testing.assert_array_equal(rn, [w[0] for w in want[-3:]])
        np.testing.assert_array_equal(re_, [w[2] for w in want[-3:]])
    store = _store(tmp_path, ram)
    disk = tcsr.build_csr(store, path=tmp_path / "csr", chunk_events=173)
    reopened = tcsr.CSRIndex.open(tmp_path / "csr")
    for other in (disk, reopened):
        for f in ("indptr", "nbr", "ts", "eid"):
            assert np.array_equal(np.asarray(getattr(other, f)),
                                  np.asarray(getattr(index, f)))
    jcsr.build_csr(tiny_stream, path=tmp_path / "jcsr", chunk_events=311)
    assert _files(tmp_path / "csr") == _files(tmp_path / "jcsr")
    # eid recovers the event's features from the store
    nbr, _, eid = index.neighbors(7)
    for e in eid[:5]:
        np.testing.assert_array_equal(store.window(int(e), int(e) + 1).feat[0],
                                      ram.feat[int(e)])
    hdr = json.loads((tmp_path / "csr" / tcsr.HEADER_NAME).read_text())
    (tmp_path / "csr" / tcsr.HEADER_NAME).write_text(
        json.dumps({**hdr, "magic": "junk"}))
    with pytest.raises(ValueError, match="bad magic"):
        tcsr.CSRIndex.open(tmp_path / "csr")


def test_convert_cli_matches_jax_tool(tmp_path, capsys):
    """`python -m repro_torch.launch.convert_events --synthetic stream-tiny
    --csr` writes the files JAX's tools/convert_events.py writes; --csv
    too."""
    import importlib.util
    from repro_torch.launch import convert_events
    spec = importlib.util.spec_from_file_location(
        "convert_events_jax", ROOT / "tools" / "convert_events.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    args = dict(csv=None, dataset=None, synthetic="stream-tiny",
                chunk_events=20_000, seed=0, csr=True)
    assert convert_events.main(["--synthetic", "stream-tiny", "--out",
                                str(tmp_path / "p"), "--csr",
                                "--chunk-events", "7000"]) == 0
    assert tool.convert(types.SimpleNamespace(out=str(tmp_path / "j"),
                                              **args)) == 0
    assert "wrote" in capsys.readouterr().out
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert _files(tmp_path / "p" / "csr") == _files(tmp_path / "j" / "csr")
    csv = ROOT / "tests" / "data" / "mini_jodie.csv"
    store = convert_events.convert(types.SimpleNamespace(
        out=str(tmp_path / "csv"), csv=str(csv), dataset=None,
        synthetic=None, chunk_events=4, seed=0, csr=False, n_events=None))
    ram_csv = tevents.load_jodie_csv(str(csv))
    assert store.dst_range() == (3, 6)
    _assert_streams_equal(store.stream(), ram_csv)
    _assert_batches_equal(store.stream().iter_temporal_batches(4, "cpu"),
                          ram_csv.iter_temporal_batches(4, "cpu"))
