"""The port's train -> checkpoint -> serve path against the JAX package on
the CPU: `load_jodie_csv`, the checkpoint file format (the manifest's
bytes against msgpack's, the treedef string against jax.tree's, files
written by either package loaded by the other), the named errors of a
mismatched restore, `ServeEngine.from_checkpoint`, the `tgn-pres`
config, and the CLIs' `--csv` and `--checkpoint`.

Tolerances: the csv arrays byte for byte; checkpoint leaves bit for bit
both ways; the restored engines' query scores 1e-5 (JAX's jitted engine
against the port's plain versions on the same leaves)."""
from __future__ import annotations

import dataclasses
import pathlib

import msgpack
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax

from repro.checkpoint import io as jio
from repro.configs import tgn_pres as jtgn_pres
from repro.graph.events import load_jodie_csv as jload_csv
from repro.models import mdgnn as jmdgnn
from repro.serve import MicroBatcher as JBatcher
from repro.serve import ServeEngine as JEngine

from repro_torch import bridge
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_config
from repro_torch.configs import tgn_pres as ttgn_pres
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph.events import EventStream
from repro_torch.graph.events import load_jodie_csv as tload_csv
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.serve import MicroBatcher, ServeEngine

CSV = pathlib.Path(__file__).parent / "data" / "mini_jodie.csv"
BUCKETS = (16, 64)

# config name -> MDGNNConfig changes; "pipelined" is the bundle a run at
# pipeline depth 2 saves (its state is the lag-one state's)
CONFIGS = {"tgn": dict(use_pres=True), "apan": dict(variant="apan"),
           "jodie": dict(variant="jodie", n_layers=2),
           "buckets": dict(use_pres=True, pres_buckets=8),
           "pipelined": dict(use_pres=True, pipeline_depth=2)}


def _jcfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=8, d_msg=8, d_time=4,
                d_embed=8, n_neighbors=3, use_kernels=True)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _tcfg(jcfg):
    return tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))


def _jbundle(jcfg):
    params, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    return {"params": params, "state": jmdgnn.init_state(jcfg)}


def _tbundle(cfg, seed=0):
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
    return params, tmdgnn.init_state(cfg, "cpu")


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


# ---------------------------------------------------------------------------
# load_jodie_csv
# ---------------------------------------------------------------------------


def _assert_streams_equal(got, want):
    for col in ("src", "dst", "t", "feat"):
        x, y = getattr(got, col), getattr(want, col)
        assert x.dtype == y.dtype and x.shape == y.shape, col
        assert x.tobytes() == y.tobytes(), col
    assert got.num_nodes == want.num_nodes


def test_load_jodie_csv_byte_identical_on_mini_csv():
    """The checked-in file holds a truncated and a blank row: the tolerant
    re-read's arrays, byte for byte JAX's."""
    _assert_streams_equal(tload_csv(str(CSV)), jload_csv(str(CSV)))


@pytest.mark.parametrize("kind", ["clean", "truncated", "no_features"])
def test_load_jodie_csv_byte_identical(tmp_path, kind):
    rng = np.random.default_rng(3)
    rows = ["user_id,item_id,timestamp,state_label,f0,f1,f2"]
    for _ in range(40):
        u, i = rng.integers(0, 9), rng.integers(0, 5)
        t = float(rng.integers(0, 12)) / 2          # ties: a stable sort
        f = ",".join(f"{x:.3f}" for x in rng.normal(size=3))
        rows.append(f"{u},{i},{t},0,{f}")
    if kind == "truncated":
        rows.insert(7, "3,1")
        rows.insert(20, "")
    if kind == "no_features":
        rows = [",".join(r.split(",")[:4]) for r in rows]
    path = tmp_path / f"{kind}.csv"
    path.write_text("\n".join(rows) + "\n")
    _assert_streams_equal(tload_csv(str(path)), jload_csv(str(path)))
    _assert_streams_equal(tload_csv(str(path), num_nodes=40),
                          jload_csv(str(path), num_nodes=40))


def test_train_cli_csv_on_cpu(capsys):
    """--csv trains on the mini csv; its validation split is one event, so
    the lag-one pass scores no pair and val AP is nan (JAX raises)."""
    from repro_torch.launch import train as tcli
    hist = tcli.main(["--csv", str(CSV), "--model", "tgn", "--pres",
                      "--use-kernels", "--device", "cpu", "--d-mem", "8",
                      "--batch-size", "2", "--epochs", "1"])
    out = capsys.readouterr().out
    assert f"on {CSV}: 4 events, K=2 batches of b=2" in out
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert np.isnan(hist[0]["val_ap"])


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_treedef_matches_jax(tiny_stream, name):
    jcfg = _jcfg(tiny_stream, **CONFIGS[name])
    want = str(jax.tree.structure(_jbundle(jcfg)))
    got = tio.treedef_str(bridge.mdgnn_bundle(*_tbundle(_tcfg(jcfg))))
    assert got == want
    jl = jax.tree.leaves(_jbundle(jcfg))
    tl = tio._flatten(bridge.mdgnn_bundle(*_tbundle(_tcfg(jcfg))))[0]
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]


def test_pipelined_run_saves_the_lag_one_layout(tiny_stream, tiny_spec):
    """A pipelined epoch returns the lag-one state, so its bundle has the
    lag-one treedef, as JAX's pipelined run saves."""
    from repro_torch.optim import adamw
    from repro_torch.train import pipeline
    cfg = _tcfg(_jcfg(tiny_stream, **CONFIGS["pipelined"]))
    params, state = _tbundle(cfg)
    opt = adamw(1e-3)
    head = EventStream(tiny_stream.src[:200], tiny_stream.dst[:200],
                       tiny_stream.t[:200], tiny_stream.feat[:200],
                       tiny_stream.num_nodes)
    _, _, state, _ = pipeline.run_epoch(
        params, opt.init(params), state, head.temporal_batches(50, "cpu"),
        cfg,
        pipeline.make_train_step(cfg, opt),
        torch.Generator().manual_seed(0), _dst(tiny_spec))
    jcfg = _jcfg(tiny_stream, **CONFIGS["pipelined"])
    assert tio.treedef_str(bridge.mdgnn_bundle(params, state)) == \
        str(jax.tree.structure(_jbundle(jcfg)))


def _manifests(tiny_stream):
    out = []
    for name in ("tgn", "apan"):
        bundle = _jbundle(_jcfg(tiny_stream, **CONFIGS[name]))
        out.append({"treedef": str(jax.tree.structure(bundle)),
                    "n_leaves": len(jax.tree.leaves(bundle))})
    return out


def test_manifest_bytes_match_msgpack(tiny_stream):
    """The port's manifest is msgpack.packb's byte for byte, for both
    packages' bundles and at every str and int width, and msgpack reads
    it back."""
    cases = _manifests(tiny_stream)
    cases += [{"treedef": "x" * n, "n_leaves": v}
              for n, v in ((0, 0), (31, 127), (32, 128), (255, 255),
                           (256, 256), (65535, 65535), (65536, 65536),
                           (70_000, 2 ** 32))]
    for m in cases:
        packed = tio.pack_manifest(m)
        assert packed == msgpack.packb(m)
        assert msgpack.unpackb(packed) == m
        assert tio.unpack_manifest(msgpack.packb(m)) == m


def _fold_jax(jcfg, bundle, stream, dst, n=120):
    """A JAX engine's state after `n` events, so the bundle holds written
    rows, rings and trackers."""
    eng = JEngine(jcfg, bundle["params"], bundle["state"], item_range=dst,
                  batcher=JBatcher(buckets=BUCKETS, d_edge=jcfg.d_edge))
    eng.ingest(stream.src[:n], stream.dst[:n], stream.t[:n],
               stream.feat[:n])
    return {"params": bundle["params"], "state": eng.state}


@pytest.mark.parametrize("name", ["tgn", "apan"])
def test_jax_bundle_serves_in_port(tiny_stream, tiny_spec, tmp_path, name):
    """A bundle JAX's save_checkpoint wrote loads in the port bit for bit,
    and the port's from_checkpoint engine scores as JAX's
    from_checkpoint engine does."""
    dst = _dst(tiny_spec)
    jcfg = _jcfg(tiny_stream, **CONFIGS[name])
    bundle = _fold_jax(jcfg, _jbundle(jcfg), tiny_stream, dst)
    path = str(tmp_path / "jax.ckpt")
    jio.save_checkpoint(path, bundle)
    cfg = _tcfg(jcfg)
    like = bridge.mdgnn_bundle(*_tbundle(cfg))
    got = tio._flatten(tio.read_checkpoint(path, like))[0]
    for g, w in zip(got, jax.tree.leaves(bundle)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    kw = dict(item_range=dst)
    je = JEngine.from_checkpoint(path, jcfg, **kw,
                                 batcher=JBatcher(buckets=BUCKETS,
                                                  d_edge=jcfg.d_edge))
    te = ServeEngine.from_checkpoint(path, cfg, device="cpu", **kw,
                                     batcher=MicroBatcher(
                                         buckets=BUCKETS, d_edge=cfg.d_edge))
    q = slice(120, 150)
    s, d, t = tiny_stream.src[q], tiny_stream.dst[q], tiny_stream.t[q]
    np.testing.assert_allclose(te.query(s, d, t), je.query(s, d, t),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["tgn", "jodie", "buckets"])
def test_port_bundle_loads_in_jax(tiny_stream, tiny_spec, tmp_path, name):
    """A bundle the port wrote (after some folds) loads in JAX's
    load_checkpoint leaf for leaf, bit for bit, dump rows dropped."""
    dst = _dst(tiny_spec)
    cfg = _tcfg(_jcfg(tiny_stream, **CONFIGS[name]))
    params, state = _tbundle(cfg, seed=3)
    eng = ServeEngine(cfg, params, state, item_range=dst, device="cpu",
                      batcher=MicroBatcher(buckets=BUCKETS,
                                           d_edge=cfg.d_edge))
    eng.ingest(tiny_stream.src[:100], tiny_stream.dst[:100],
               tiny_stream.t[:100], tiny_stream.feat[:100])
    path = str(tmp_path / "port.ckpt")
    tio.save_checkpoint(path, bridge.mdgnn_bundle(params, state))
    back = jio.load_checkpoint(
        path, _jbundle(_jcfg(tiny_stream, **CONFIGS[name])))
    want = tio._flatten(bridge.mdgnn_bundle(params, state))[0]
    for g, w in zip(jax.tree.leaves(back), want):
        g, w = np.asarray(g), w.numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("change,match", [
    (dict(variant="apan"), "leaves but the restore template has"),
    (dict(variant="jodie", n_layers=3), "tree structure does not match"),
    (dict(d_mem=12, d_msg=12, d_embed=12), "has shape"),
])
def test_mismatched_config_raises(tiny_stream, tmp_path, change, match):
    """A TGN bundle restored under another config raises the JAX module's
    named ValueError (leaf count, nesting: JODIE at 3 layers has TGN's
    leaf count, a leaf's shape), before any tensor is made."""
    cfg = _tcfg(_jcfg(tiny_stream, **CONFIGS["tgn"]))
    path = str(tmp_path / "tgn.ckpt")
    tio.save_checkpoint(path, bridge.mdgnn_bundle(*_tbundle(cfg)))
    other = dataclasses.replace(cfg, **change)
    with pytest.raises(ValueError, match=match):
        ServeEngine.from_checkpoint(path, other, device="cpu")
    with pytest.raises(ValueError, match=match):
        tio.load_checkpoint(path, bridge.mdgnn_bundle(*_tbundle(other)),
                            device="cpu")
    # and JAX's loader names the same mismatch in the port's file
    with pytest.raises(ValueError, match=match):
        jio.load_checkpoint(path, _jbundle(_jcfg(
            tiny_stream, **dict(CONFIGS["tgn"], **change))))


def test_load_checkpoint_casts_to_the_template(tiny_stream, tmp_path):
    cfg = _tcfg(_jcfg(tiny_stream))
    params, state = _tbundle(cfg)
    path = str(tmp_path / "a.ckpt")
    tio.save_checkpoint(path, {"p": params["dec"], "n": state["pres"].n})
    like = {"p": {k: v.double() for k, v in params["dec"].items()},
            "n": state["pres"].n}
    got = tio.load_checkpoint(path, like, device="cpu")
    assert got["p"]["w1"].dtype == torch.float64
    assert torch.equal(got["p"]["w1"], params["dec"]["w1"].double())
    assert torch.equal(got["n"], state["pres"].n)


# ---------------------------------------------------------------------------
# the paper's config and the CLIs
# ---------------------------------------------------------------------------


def test_tgn_pres_configs_match_jax():
    assert get_config("tgn-pres") is ttgn_pres.CONFIG
    for name in ("CONFIG", "PRODUCTION"):
        assert dataclasses.asdict(getattr(ttgn_pres, name)) == \
            dataclasses.asdict(getattr(jtgn_pres, name)), name
    tmdgnn.check_supported(ttgn_pres.CONFIG)
    # PRODUCTION names an event store, ported by the fourteenth slice
    tmdgnn.check_supported(ttgn_pres.PRODUCTION)
    # memory parallelism, ported by the fifteenth slice: accepted
    tmdgnn.check_supported(dataclasses.replace(ttgn_pres.PRODUCTION,
                                               n_shards=4))


def test_cli_checkpoint_then_serve_on_cpu(tmp_path, capsys, monkeypatch):
    """The train CLI saves after its last epoch; the serve CLI restores
    it; the restored engine scores as an engine built from the trainer's
    own params and state."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tcli
    kept = {}
    bundle = bridge.mdgnn_bundle

    def keep(params, state):
        kept["params"], kept["state"] = params, tmdgnn.clone_state(state)
        return bundle(params, state)
    monkeypatch.setattr(bridge, "mdgnn_bundle", keep)
    path = str(tmp_path / "mooc.ckpt")
    model = ["--dataset", "mooc-small", "--model", "tgn", "--pres",
             "--use-kernels", "--device", "cpu", "--d-mem", "8"]
    tcli.main(model + ["--batch-size", "2000", "--epochs", "1",
                       "--checkpoint", path])
    assert f"[ckpt] saved to {path}" in capsys.readouterr().out
    monkeypatch.setattr(bridge, "mdgnn_bundle", bundle)
    rep = tserve.main(model + ["--max-events", "200", "--checkpoint", path])
    assert f"(checkpoint {path})" in capsys.readouterr().out
    assert rep.n_events == 200
    spec = tdatasets.SPECS["mooc-small"]
    stream = tdatasets.get_dataset("mooc-small", 0)
    cfg = tmdgnn.MDGNNConfig(variant="tgn", n_nodes=stream.num_nodes,
                             d_edge=stream.feat_dim, d_mem=8, d_msg=8,
                             d_embed=8, use_pres=True, use_kernels=True)
    dst = _dst(spec)
    restored = ServeEngine.from_checkpoint(path, cfg, device="cpu",
                                           item_range=dst)
    live = ServeEngine(cfg, kept["params"], kept["state"], item_range=dst,
                       device="cpu")
    rng = np.random.default_rng(0)
    s = rng.integers(0, spec.n_users, 40).astype(np.int32)
    d = rng.integers(*dst, 40).astype(np.int32)
    t = np.full(40, 1e4, np.float32)
    np.testing.assert_array_equal(restored.query(s, d, t),
                                  live.query(s, d, t))
