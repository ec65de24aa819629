"""The port's execution policy and autotune cache (repro_torch.kernels.ops,
repro_torch.kernels.autotune) on the CPU, against the JAX package's where
both define the same thing (mode names and errors, shape signatures, the
dispatch table's keys after two train steps).

The precedence chain per-call > env var > autotune cache > the device's
default is observed through what each mode does to CPU tensors: "oracle"
returns the plain version, "compiled" raises (the CUDA launchers refuse
CPU tensors). The cuda rules (no "oracle" winner is recorded, no cached
"oracle" entry is dispatched to a CUDA tensor) are held through a fake
CUDA resolution: `ops.resolve_mode` given a cuda device and CPU arguments
(it reads only their shapes). Signatures and tables are compared exactly;
the plain version's output exactly (the same function on the same
tensors)."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.train import loop as jloop

from repro_torch.graph import events as tevents
from repro_torch.kernels import autotune, ops, ref
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import loop as tloop

CUDA = torch.device("cuda", 0)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """The cache in a temp dir, every policy memo reset on the way in and
    out (the env var and the cache file are read once a process)."""
    monkeypatch.setattr(autotune, "CACHE_DIR", tmp_path)
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    ops.reset_execution_policy()
    yield tmp_path
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    ops.reset_execution_policy()


def _gru_np(m=32, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32),
            (rng.normal(size=(d, 3 * d)) * 0.1).astype(np.float32),
            (rng.normal(size=(d, 3 * d)) * 0.1).astype(np.float32),
            np.zeros((3 * d,), np.float32))


def _gru_args(m=32, d=16, seed=0):
    return tuple(torch.from_numpy(a) for a in _gru_np(m, d, seed))


def _fake_timer(winner_mode):
    """The designated mode measures 1 ms, every other 100 ms."""
    def timer(fn, args, cand, repeats=3):
        del fn, args, repeats
        return 1.0 if cand["mode"] == winner_mode else 100.0
    return timer


# ---------------------------------------------------------------------------
# modes and precedence
# ---------------------------------------------------------------------------


def test_mode_errors_name_valid_modes(tmp_cache, monkeypatch):
    assert ops.MODES == jops.MODES and ops.ENV_VAR == jops.ENV_VAR
    for dispatch in (ops.dispatch, jops.dispatch):
        args = (_gru_args() if dispatch is ops.dispatch
                else tuple(jnp.asarray(a) for a in _gru_np()))
        with pytest.raises(ValueError, match="unknown kernel execution mode"):
            dispatch("gru_cell", *args, mode="fast")
        with pytest.raises(ValueError,
                           match="auto, compiled, interpret, oracle"):
            dispatch("gru_cell", *args, mode="fast")
    with pytest.raises(NotImplementedError, match="interpreter"):
        ops.dispatch("gru_cell", *_gru_args(), mode="interpret")
    monkeypatch.setenv(ops.ENV_VAR, "warp")
    ops.reset_execution_policy()
    with pytest.raises(ValueError, match="unknown kernel execution mode"):
        ops.dispatch("gru_cell", *_gru_args())
    with pytest.raises(ValueError, match="unknown kernel execution mode"):
        ops.execution_policy()


def test_precedence_per_call_env_cache_default(tmp_cache, monkeypatch):
    args = _gru_args()
    want = ref.gru_cell_ref(*args)
    pol = ops.execution_policy()
    assert pol["env_mode"] is None and pol["autotune_entries"] == 0
    assert pol["backend"] == ops.backend()
    # the default for CPU tensors: the plain version
    assert ops.resolve_mode(None, "cpu", "gru_cell", args) == "oracle"
    assert torch.equal(ops.dispatch("gru_cell", *args), want)
    # a cache entry beats the default: "compiled" reaches the launcher,
    # which refuses CPU tensors
    autotune.record("cpu", "gru_cell", args,
                    {"mode": "compiled", "blocks": {}, "ms": 0.1})
    assert ops.execution_policy()["autotune_entries"] == 1
    assert ops.resolve_mode(None, "cpu", "gru_cell", args) == "compiled"
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dispatch("gru_cell", *args)
    # another shape has no entry: the default again
    other = _gru_args(m=8)
    assert torch.equal(ops.dispatch("gru_cell", *other),
                       ref.gru_cell_ref(*other))
    # the env var beats the cache
    monkeypatch.setenv(ops.ENV_VAR, "oracle")
    ops.reset_execution_policy()
    assert ops.execution_policy()["env_mode"] == "oracle"
    assert torch.equal(ops.dispatch("gru_cell", *args), want)
    # a per-call mode beats the env var ("auto" is no pin)
    monkeypatch.setenv(ops.ENV_VAR, "compiled")
    ops.reset_execution_policy()
    assert ops.execution_policy()["default_mode"] == "compiled"
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dispatch("gru_cell", *args, mode="auto")
    assert torch.equal(ops.dispatch("gru_cell", *args, mode="oracle"), want)


def test_shape_sig_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    cases = [
        (rng.normal(size=(32, 16)).astype(np.float32),
         rng.integers(0, 9, size=(5,)).astype(np.int32),
         rng.random(4) < 0.5, 0.5, 3),
        (np.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
         np.zeros((0, 7), np.float32), np.float32(2.0)),
    ]
    for args in cases:
        sig = autotune.shape_sig(args)
        assert sig == jautotune.shape_sig(args)
        assert autotune.shape_sig([torch.from_numpy(np.asarray(a))
                                   if isinstance(a, np.ndarray)
                                   and a.dtype != jnp.bfloat16 else a
                                   for a in args]) == sig
    t = autotune.shape_sig((torch.zeros(2, 3, dtype=torch.bfloat16),
                            torch.zeros(4, dtype=torch.bool),
                            torch.zeros(1, dtype=torch.int64)))
    assert t == "bfloat16[2,3];bool[4];int64[1]"
    assert autotune.shape_sig(_gru_args(32)) != autotune.shape_sig(
        _gru_args(64))


# ---------------------------------------------------------------------------
# the tuner and the cache
# ---------------------------------------------------------------------------


def test_tune_picks_deterministic_winner(tmp_cache):
    args = _gru_args()
    assert autotune.candidates("gru_cell", "cpu") == [
        {"mode": "oracle", "blocks": {}}]
    assert autotune.candidates("gru_cell", "cuda") == [
        {"mode": "compiled", "blocks": {}}]
    best = autotune.tune("gru_cell", args, backend="cpu",
                         modes=("oracle", "compiled"),
                         timer=_fake_timer("compiled"))
    assert best == {"mode": "compiled", "blocks": {}, "ms": 1.0, "swept": 2}
    # on cuda the plain version is timed beside the winner
    best = autotune.tune("gru_cell", args, backend="cuda",
                         timer=_fake_timer("compiled"))
    assert best == {"mode": "compiled", "blocks": {}, "ms": 1.0, "swept": 1,
                    "oracle_ms": 100.0}
    with pytest.raises(ValueError, match="unknown kernel execution mode"):
        autotune.candidates("gru_cell", "cpu", modes=("fast",))


def test_cache_round_trip_and_measure_once(tmp_cache):
    args = _gru_args()
    calls = []

    def counting_timer(fn, a, cand, repeats=3):
        calls.append(cand["mode"])
        return 1.0

    entry = autotune.autotune("gru_cell", args, backend="cpu",
                              timer=counting_timer)
    p = autotune.cache_path("cpu")
    assert p == tmp_cache / "torch-cpu.json"
    data = json.loads(p.read_text())
    key = f"gru_cell|{autotune.shape_sig(args)}"
    assert data["backend"] == "cpu" and data["torch"] == torch.__version__
    assert data["entries"][key] == entry == {"mode": "oracle", "blocks": {},
                                             "ms": 1.0, "swept": 1}
    assert autotune.lookup("cpu", "gru_cell", args) == entry
    assert calls == ["oracle"]
    autotune.autotune("gru_cell", args, backend="cpu", timer=counting_timer)
    assert calls == ["oracle"]                      # a hit: no measurement
    autotune.autotune("gru_cell", args, backend="cpu", timer=counting_timer,
                      force=True)
    assert calls == ["oracle"] * 2
    # JAX's file in the same directory (entries naming Pallas modes) is
    # never read
    (tmp_cache / "cpu.json").write_text(json.dumps({"entries": {
        f"pres_predict|{autotune.shape_sig(args[:3])}":
            {"mode": "interpret", "blocks": {}, "ms": 1.0}}}))
    autotune.clear_cache()
    assert autotune.lookup("cpu", "pres_predict", args[:3]) is None
    assert autotune.n_entries("cpu") == 1


def test_tune_raises_when_every_candidate_fails(tmp_cache):
    def failing_timer(fn, args, cand, repeats=3):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.tune("gru_cell", _gru_args(), backend="cpu",
                      timer=failing_timer)
    # the default timer on a mode that cannot run on CPU tensors
    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.tune("gru_cell", _gru_args(), backend="cpu",
                      modes=("compiled", "interpret"))


def test_cuda_refuses_the_plain_version_unpinned(tmp_cache):
    """On cuda, `record` refuses an "oracle" winner and a cached "oracle"
    entry is refused for a CUDA tensor (a fake CUDA resolution: the cuda
    device with CPU arguments, whose shapes are all it reads); a pinned
    "oracle" still resolves."""
    args = _gru_args()
    best = autotune.tune("gru_cell", args, backend="cuda",
                         modes=("compiled", "oracle"),
                         timer=_fake_timer("oracle"))
    assert best["mode"] == "oracle"
    with pytest.raises(ValueError, match="refusing"):
        autotune.record("cuda", "gru_cell", args, best)
    with pytest.raises(ValueError, match="refusing"):
        autotune.autotune("gru_cell", args, backend="cuda",
                          modes=("oracle",), timer=_fake_timer("oracle"))
    assert not autotune.cache_path("cuda").exists()
    # a file written by other means
    autotune.cache_path("cuda").write_text(json.dumps({"entries": {
        f"gru_cell|{autotune.shape_sig(args)}":
            {"mode": "oracle", "blocks": {}, "ms": 1.0}}}))
    autotune.clear_cache()
    with pytest.raises(ValueError, match="pins it"):
        ops.resolve_mode(None, CUDA, "gru_cell", args)
    assert ops.resolve_mode("oracle", CUDA, "gru_cell", args) == "oracle"
    assert ops.resolve_mode(None, CUDA, "gru_cell", _gru_args(m=8)) == \
        "compiled"
    # a cached "compiled" entry resolves
    autotune.record("cuda", "gru_cell", args,
                    {"mode": "compiled", "blocks": {}, "ms": 1.0})
    assert ops.resolve_mode(None, CUDA, "gru_cell", args) == "compiled"


def test_emitted_shapes_cover_the_registry(tmp_cache):
    """The sweep's shapes: every registered kernel, recorded from the
    model's own calls (here at d 8 on the CPU, tuned into the cache)."""
    rows = autotune.sweep("cpu", d_mem=8, timer=_fake_timer("oracle"))
    assert {r["kernel"] for r in rows} == set(ops.REGISTRY)
    assert all(r["mode"] == "oracle" for r in rows)
    assert autotune.n_entries("cpu") == len(rows)


# ---------------------------------------------------------------------------
# the dispatch table
# ---------------------------------------------------------------------------


def test_dispatch_log_keys_match_jax(tiny_stream, tiny_spec, tmp_cache):
    """After two Alg. 2 train steps on the CPU the table holds the same
    (kernel, mode) keys as JAX's. The counts differ by design: the port
    counts every call, JAX once a trace."""
    jcfg = jmdgnn.MDGNNConfig(
        variant="tgn", n_nodes=tiny_stream.num_nodes,
        d_edge=tiny_stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
        d_embed=16, n_neighbors=4, use_pres=True, use_kernels=True)
    dst = (tiny_spec.n_users, tiny_spec.n_users + tiny_spec.n_items)
    sub = tiny_stream.slice(0, 300)
    jops.reset_dispatch_log()
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = joptim.adamw(1e-3)
    jloop.run_epoch(jparams, jopt.init(jparams), jmdgnn.init_state(jcfg),
                    sub.temporal_batches(100), jcfg,
                    jloop.make_train_step(jcfg, jopt),
                    jax.random.PRNGKey(0), dst)
    want = jops.dispatch_log()
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    ops.reset_dispatch_log()
    params = tmdgnn.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    opt = toptim.adamw(1e-3)
    tstream = tevents.EventStream(sub.src, sub.dst, sub.t, sub.feat,
                                  sub.num_nodes)
    tloop.run_epoch(params, opt.init(params), tmdgnn.init_state(tcfg, "cpu"),
                    tstream.temporal_batches(100, "cpu"), tcfg,
                    tloop.make_train_step(tcfg, opt),
                    torch.Generator().manual_seed(0), dst)
    got = ops.dispatch_log()
    keys = lambda t: sorted((k, m) for k, ms in t.items() for m in ms)
    assert keys(got) == keys(want) == [("embed_attn", "oracle"),
                                       ("memory_update_table", "oracle")]
    assert all(n == 2 for ms in got.values() for n in ms.values())
    ops.reset_dispatch_log()
    assert ops.dispatch_log() == {}
