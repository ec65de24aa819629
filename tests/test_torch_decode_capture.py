"""The zoo's decode step with the position on the device (JAX's
`jax.jit(model.decode_step)` with `pos` a traced int32 scalar,
`repro/launch/serve.py`), and `launch/serve.py::DecodeStep`, which on the
card replays it as one CUDA graph for every position.

A 0-d integer tensor `pos` is read on the device only, so it gives the
same logits and caches as an int `pos`, bit for bit (the same operations
on the same values), for each of the ten decoding arches in both parameter
layouts, past gemma3's window (its ring buffer wraps) and through
qwen2-vl's M-RoPE; the tensor-pos body runs on meta tensors, where a read
of a value on the host raises. `DecodeStep` runs eagerly on the CPU
(`captured` False, no reason); with its replay emulated by the body run
on the static inputs it gives the eager loop's tokens and states, and
its host check raises the int path's ValueError before anything is
written; `serve --zoo` reports whether it decoded captured in its line
and its `--metrics-out` run-log. One tensor-pos run of the reduced qwen3 is held against JAX's
jitted decode within TOL * max(1, |ref|), tests/test_torch_zoo.py's
tolerance; the other arches are tied to JAX through the int path
(`test_torch_zoo.py::test_reduced_model_matches_jax` and the zoo's other
files) and the bit-equality here."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.configs import get_config as jget_config

from repro_torch import bridge
from repro_torch.archs import api
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as tserve
from repro_torch.train import capture as tcapture

TOL = 1e-5
B = 2
META = torch.device("meta")


def _setup(arch, cache, **kw):
    """The reduced config of `arch` (with `kw`), its model, parameters and
    first tokens drawn from seed 0, and a decode state of `cache` slots
    (whisper's encoder output drawn too)."""
    cfg = get_config(arch).reduced(**kw)
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen)
    state = model.init_decode_state(B, cache, "cpu")
    if model.encode is not None:
        state["enc_out"] = torch.randn(state["enc_out"].shape,
                                       generator=gen).to(cfg.dtype)
    return cfg, model, params, tokens, state


def _greedy(step, params, state, tokens, positions, as_tensor=False):
    """Greedy decode at `positions` through `step`; the logits of every
    step and the final state."""
    logits = []
    with torch.no_grad():
        for pos in positions:
            p = torch.tensor(pos, dtype=torch.int32) if as_tensor else pos
            lg, state = step(params, state, tokens, p)
            logits.append(lg)
            tokens = lg[:, -1].argmax(-1, keepdim=True)
    return logits, state


def _assert_equal(got, want):
    a, b = tcapture.leaves(got), tcapture.leaves(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _emulate_replay(step):
    """`step` (a DecodeStep) on the CPU as on the card, its replay
    emulated: the body runs on the inputs (the 0-d position tensor) and a
    state leaf returned in new storage is copied back into the carry, as
    the graph's end does."""
    step.eager = lambda *a, **kw: False

    def run(key, fn, carry, inputs, **kw):
        new, logits = fn(carry, inputs)
        for old, x in zip(tcapture.leaves(carry), tcapture.leaves(new)):
            if x.data_ptr() != old.data_ptr():
                old.copy_(x)
        return logits.clone()

    step.run = run
    return step


# ---------------------------------------------------------------------------
# a tensor position against an int one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [False, True], ids=["units", "stacked"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tensor_pos_equals_int_pos(arch, scan):
    """Six greedy steps from equal states: the logits of every step and
    every cache or state leaf equal bit for bit."""
    cfg, model, params, tokens, state = _setup(arch, 8, scan_layers=scan)
    twin = tcapture.clone(state)
    want, ws = _greedy(model.decode_step, params, state, tokens, range(6))
    got, gs = _greedy(model.decode_step, params, twin, tokens, range(6),
                      as_tensor=True)
    _assert_equal(got, want)
    _assert_equal(gs, ws)


@pytest.mark.parametrize("arch,kw", [
    ("gemma3-12b", dict(window=4)),
    ("qwen2-vl-2b", {})], ids=["gemma3-ring", "qwen2-vl-mrope"])
def test_tensor_pos_past_the_window(arch, kw):
    """gemma3's windowed ring (4 slots) wrapped twice beside its global
    layer's 12-slot cache, and qwen2-vl's M-RoPE, in bfloat16 over ten
    steps: bit for bit as the int position."""
    cfg, model, params, tokens, state = _setup(arch, 12, dtype=torch.bfloat16,
                                               **kw)
    twin = tcapture.clone(state)
    want, ws = _greedy(model.decode_step, params, state, tokens, range(10))
    got, gs = _greedy(model.decode_step, params, twin, tokens, range(10),
                      as_tensor=True)
    if arch == "gemma3-12b":
        lengths = {x.shape[1] for x in tcapture.leaves(state)}
        assert lengths == {4, 12}, lengths
    _assert_equal(got, want)
    _assert_equal(gs, ws)


def _no_host_data(*a, **kw):
    raise AssertionError("a tensor built from host data: on the card a "
                         "copy from the host, which a capture refuses")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tensor_pos_body_on_meta(arch, monkeypatch):
    """The decode body with a tensor position on meta tensors (shapes
    without data), where `int()`, `.item()` or a slice by the position
    raises, and with `torch.tensor` / `torch.as_tensor` refused (a tensor
    built from host data is a copy from the host on the card): on the
    card the step is one CUDA graph for every position."""
    monkeypatch.setattr(torch, "tensor", _no_host_data)
    monkeypatch.setattr(torch, "as_tensor", _no_host_data)
    cfg = get_config(arch).reduced()
    model = api.get_model(cfg)
    params = model.build_params(None, META)[0]
    state = model.init_decode_state(B, 8, META)
    tokens = torch.zeros((B, 1), dtype=torch.int64, device=META)
    pos = torch.zeros((), dtype=torch.int32, device=META)
    with torch.no_grad():
        logits, state = model.decode_step(params, state, tokens, pos)
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    assert logits.device == META
    assert all(x.device == META for x in tcapture.leaves(state))


# ---------------------------------------------------------------------------
# DecodeStep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-12b", "xlstm-350m", "whisper-tiny"])
def test_decode_step_on_cpu(arch):
    """On the CPU the step runs the eager body (`captured` False, no
    reason); with its replay emulated it gives the eager loop's logits
    and state, xLSTM's state (returned in new storage) copied back into
    the caller's state as init_decode_state made it (no leaf of which may
    alias another)."""
    cfg, model, params, tokens, state = _setup(arch, 8)
    twin, third = tcapture.clone(state), tcapture.clone(state)
    want, ws = _greedy(model.decode_step, params, twin, tokens, range(6))
    step = tserve.make_decode_step(model)
    got, gs = _greedy(step, params, third, tokens, range(6))
    assert step.captured is False and step.eager_reason is None
    _assert_equal(got, want)
    _assert_equal(gs, ws)
    emulated = _emulate_replay(tserve.make_decode_step(model))
    got, gs = _greedy(emulated, params, state, tokens, range(6))
    assert gs is state
    _assert_equal(got, want)
    _assert_equal(gs, ws)


def test_decode_step_static_reasons():
    """On a CUDA device the step is captured unless `capture=False`."""
    model = api.get_model(get_config("qwen3-0.6b").reduced())
    cuda = torch.device("cuda", 0)
    step = tserve.make_decode_step(model)
    assert step.eager(cuda) is False and step.captured is True
    off = tserve.make_decode_step(model, capture=False)
    assert off.eager(cuda) is True and off.captured is False
    assert off.eager_reason == "capture=False"


@pytest.mark.parametrize("arch,cache,pos,match", [
    ("gemma3-12b", 4, 4, r"position 4 .*cache_len 4"),
    ("zamba2-1.2b", 4, 4, r"position 4 .*cache_len 4"),
    ("kimi-k2-1t-a32b", 4, 4, r"position 4 .*cache_len 4"),
    ("whisper-tiny", 520, 512, r"position 512 .*position table "
                               r"\(max_seq 512\)"),
    ("whisper-tiny", 4, 4, r"position 4 .*cache_len 4")],
    ids=["gemma3", "zamba2", "kimi", "whisper-table", "whisper-cache"])
def test_decode_step_checks_pos_before_writing(arch, cache, pos, match):
    """A position past a global layer's cache, or past whisper's
    position table, raises the int path's ValueError (as
    tests/test_torch_zoo.py::test_decode_past_the_cache_raises) from the
    host check, before the replay writes anything: the state is left as
    it was (the eager gemma3 step writes its local layer first)."""
    cfg, model, params, tokens, state = _setup(arch, cache)
    _greedy(model.decode_step, params, state, tokens, range(min(cache, 3)))
    before = tcapture.clone(state)
    step = _emulate_replay(tserve.make_decode_step(model))
    with pytest.raises(ValueError, match=match):
        step(params, state, tokens, pos)
    _assert_equal(state, before)
    with pytest.raises(ValueError, match=match):
        model.decode_step(params, state, tokens, pos)


def test_serve_zoo_reports_capture(tmp_path, capsys):
    """`serve --zoo` decodes through the decode step, prints whether it
    was captured and writes it to `--metrics-out`'s decode record (on the
    CPU: eager, no reason)."""
    from repro_torch.obs import sink
    out = tmp_path / "zoo.jsonl"
    toks = tserve.main(["--zoo", "qwen3-0.6b", "--steps", "2", "--device",
                        "cpu", "--metrics-out", str(out)])
    assert tuple(toks.shape) == (B, 2)
    assert "captured=False" in capsys.readouterr().out
    recs = {r["kind"]: r for r in sink.read_runlog(out)}
    assert recs["manifest"]["role"] == "serve-zoo"
    assert recs["decode"]["captured"] is False
    assert recs["decode"]["eager_reason"] is None
    assert recs["decode"]["steps"] == 2


def test_xlstm_has_no_position_check():
    """xLSTM keeps no cache: its decode takes any position, with an int
    and through the decode step's host check."""
    cfg, model, params, tokens, state = _setup("xlstm-350m", 4)
    assert model.check_decode_pos is None
    step = _emulate_replay(tserve.make_decode_step(model))
    with torch.no_grad():
        got, _ = step(params, tcapture.clone(state), tokens, 10_000)
        want, _ = model.decode_step(params, state, tokens, 10_000)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------


def test_tensor_pos_decode_matches_jax():
    """The reduced qwen3 (two layers), four steps with a 0-d int32 tensor
    position, against JAX's jitted decode_step fed jnp.int32(pos), from
    JAX's parameters (`bridge.zoo_params_from_numpy`)."""
    jcfg = jget_config("qwen3-0.6b").reduced()
    jmodel = japi.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, 4), 0,
                                         jcfg.vocab), np.int32)
    model = api.get_model(get_config("qwen3-0.6b").reduced())
    params = bridge.zoo_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")
    jstate = jmodel.init_decode_state(B, 16)
    jstep = jax.jit(jmodel.decode_step)
    state = model.init_decode_state(B, 16, "cpu")
    with torch.no_grad():
        for i in range(4):
            tok = toks[:, i:i + 1]
            jl, jstate = jstep(jparams, jstate, jnp.asarray(tok),
                               jnp.int32(i))
            lg, state = model.decode_step(
                params, state, torch.as_tensor(np.array(tok)),
                torch.tensor(i, dtype=torch.int32))
            want = np.asarray(jl, np.float64)
            err = float(np.abs(lg.numpy().astype(np.float64) - want).max())
            assert err <= TOL * max(1.0, float(np.abs(want).max())), (i, err)
    for name in ("k", "v"):
        want = np.asarray(jstate["u0"]["b0"][name], np.float64)
        got = state["u0"]["b0"][name].numpy().astype(np.float64)
        assert float(np.abs(got - want).max()) <= TOL * max(
            1.0, float(np.abs(want).max())), name
