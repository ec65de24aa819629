"""The zoo's sharded specs in the port (`launch/specs.py`, the logical
axes of `nn/module.py`'s builder, the arches' `param_axes` / `state_axes`,
the optimizers' `state_axes`, `configs.SHAPES`) against the JAX package
on the CPU.

- Parameter shapes and axes leaf for leaf against JAX's `abstract_init`
  for the ten reduced arches in both layouts and kimi-k2 and zamba2 at
  their published configs; decode-state axes against JAX's
  `state_axes()`; Adafactor's and SGD's state axes.
- `SHAPES`, `shape_applicable`, `rules_for` and `vocab_rules` for every
  arch x shape, held as the PartitionSpecs `logical_to_spec` gives (no
  JAX mesh needed), on the production mesh's axis names and sizes.
- The reduced qwen3 train, prefill and decode specs on a 1x1 gloo mesh
  through `apply_spec` against JAX's spec fns jitted with their
  shardings on `make_debug_mesh(1, 1)` (the decode fn without them: it
  does not trace with them on the reference side, R3;
  tests/test_distributed.py's sizes: B 2, S 64; decode S 128), from
  JAX's weights: loss and logits
  within TOL of their scale; after the AdamW step the first moments
  within GRAD_TOL of each leaf's scale and the parameters within
  STEP_TOL x lr where the gradient is not near AdamW's eps
  (tests/test_torch_zoo_train.py's limits); the spec's step also
  against the port's own single-device step.
- On a 2x2 threaded mesh: the reduced qwen3 train spec against the
  single-device step within 1e-5 (loss, first moments), its collectives
  counted; the reduced gemma3 `fsdp` spec with the
  weight-gather hook against the same spec without it, the hook's
  all-gathers of the weight shapes it names (JAX's counterpart,
  tests/test_distributed.py:256, fails on the reference side, R3)."""
from __future__ import annotations

import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.configs import SHAPES as JSHAPES
from repro.configs import InputShape as JInputShape
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.launch import mesh as jmesh_lib
from repro.launch import specs as jspecs
from repro.nn import module as jmodule
from repro.optim import optimizers as joptim

from repro_torch import bridge
from repro_torch.archs import api
from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, get_config,
                                 shape_applicable)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.nn import module as tmodule
from repro_torch.optim import optimizers as toptim
from repro_torch.train import distributed as tdist
from repro_torch.utils.tree import tree_leaves

from torch.testing._internal.distributed.fake_pg import FakeStore

from test_torch_distributed import _group, _threaded

TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-3
LR = 1e-4          # make_train_spec's learning rate
B, S, DECODE_S = 2, 64, 128


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _close(got, want, name, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


# ---------------------------------------------------------------------------
# Axes, state axes, optimizer state axes
# ---------------------------------------------------------------------------

CASES = [(a, scan, False) for a in ARCH_IDS for scan in (False, True)] + [
    ("kimi-k2-1t-a32b", True, True), ("zamba2-1.2b", True, True)]


def _ids(case):
    arch, scan, full = case
    return f"{arch}-{'full' if full else 'reduced'}-" + (
        "stacked" if scan else "units")


def _cfgs(arch, scan, full):
    if full:
        return jget_config(arch), get_config(arch)
    return (jget_config(arch).reduced(scan_layers=scan),
            get_config(arch).reduced(scan_layers=scan))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_param_shapes_and_axes_match_jax(case):
    jcfg, tcfg = _cfgs(*case)
    jshapes, jaxes = jspecs.abstract_init(japi.get_model(jcfg))
    model = api.get_model(tcfg)
    tshapes, taxes = specs.abstract_init(model)
    want = {k: tuple(v.shape) for k, v in _paths(jshapes).items()}
    got = {k: tuple(v.shape) for k, v in _paths(tshapes).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in tree_leaves(tshapes))
    assert _paths(taxes) == _paths(jaxes)
    assert model.param_axes() == taxes


@pytest.mark.parametrize("case", CASES[:len(ARCH_IDS) * 2], ids=_ids)
def test_state_axes_match_jax(case):
    jcfg, tcfg = _cfgs(*case)
    model = api.get_model(tcfg)
    assert model.state_axes() == japi.get_model(jcfg).state_axes()
    # one axes entry a state tensor (the sLSTM triple shares one)
    state = model.init_decode_state(B, DECODE_S, device="meta")
    tmodule.tree_shardings(model.state_axes(), {}, types.SimpleNamespace(
        mesh_dim_names=("data", "model")))
    assert all(t.device.type == "meta" for t in _tensors(state))


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("name,kw", [
    ("adafactor", {}), ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("adamw", {})], ids=["adafactor", "sgd", "sgd-momentum", "adamw"])
def test_optimizer_state_axes_match_jax(name, kw):
    for arch in ("arctic-480b", "qwen3-0.6b"):
        _, jaxes = jspecs.abstract_init(japi.get_model(
            jget_config(arch).reduced(scan_layers=True)))
        taxes = api.get_model(get_config(arch).reduced(
            scan_layers=True)).param_axes()
        want = joptim.OPTIMIZERS[name](1e-3, **kw).state_axes(jaxes)
        assert toptim.OPTIMIZERS[name](1e-3, **kw).state_axes(taxes) == want


# ---------------------------------------------------------------------------
# Shapes and rules
# ---------------------------------------------------------------------------

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_shapes_rules_and_vocab_rules_match_jax(mesh_name):
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    sizes = MESHES[mesh_name]
    names = tuple(sizes)
    jmesh = types.SimpleNamespace(shape=sizes, axis_names=names)
    tmesh = types.SimpleNamespace(shape=tuple(sizes.values()),
                                  mesh_dim_names=names)
    for arch in ARCH_IDS:
        jcfg, tcfg = jget_config(arch), get_config(arch)
        _, jaxes = jspecs.abstract_init(japi.get_model(jcfg.reduced()))
        for shape in SHAPES:
            assert shape_applicable(arch, shape) == jshape_applicable(
                arch, shape)
            jr = jspecs.rules_for(arch, JSHAPES[shape])
            tr = specs.rules_for(arch, SHAPES[shape])
            assert tr == jr, (arch, shape)
            jv = jspecs.vocab_rules(jcfg, jr, jmesh)
            assert specs.vocab_rules(tcfg, tr, tmesh) == jv, (arch, shape)
            for ax in list(_paths(jaxes).values()) + [
                    ("batch", "seq"), ("batch", "vocab"),
                    ("batch", None, "vocab")]:
                want = tuple(jmodule.logical_to_spec(ax, jv, names))
                assert tuple(tmodule.logical_to_spec(ax, jv, names)) == want


def test_whisper_vocab_falls_back_to_replicated():
    """whisper's 51,865 vocab does not divide over a 16-wide "model" axis:
    its logits leave the spec replicated on vocab (JAX
    tests/test_distributed.py:113)."""
    rules = dict(tmodule.DEFAULT_RULES)
    mesh = types.SimpleNamespace(shape=(16, 16),
                                 mesh_dim_names=("data", "model"))
    assert specs.vocab_rules(get_config("whisper-tiny"), rules,
                             mesh)["vocab"] is None
    assert specs.vocab_rules(get_config("qwen3-0.6b"), rules,
                             mesh)["vocab"] == "model"
    one = types.SimpleNamespace(shape=(1, 1), mesh_dim_names=("data",
                                                              "model"))
    assert specs.vocab_rules(get_config("whisper-tiny"), rules,
                             one)["vocab"] == "model"


# ---------------------------------------------------------------------------
# The reduced qwen3 specs on a 1x1 mesh against JAX's spec runs
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """JAX's reduced qwen3 train, prefill and decode specs jitted with
    their shardings on the 1x1 debug mesh, from PRNGKey(0)'s weights:
    (weights, batch, train outputs, prefill logits, decode logits)."""
    jcfg = jget_config("qwen3-0.6b").reduced()
    model = japi.get_model(jcfg)
    params = model.init(jax.random.PRNGKey(0))[0]
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    toks = jax.random.randint(k1, (B, S), 0, jcfg.vocab, jnp.int32)
    batch = {"tokens": toks,
             "targets": jax.random.randint(k2, (B, S), 0, jcfg.vocab,
                                           jnp.int32)}
    mesh = jmesh_lib.make_debug_mesh(1, 1)

    def jit(spec):
        return jax.jit(spec.fn, in_shardings=spec.in_shardings,
                       out_shardings=spec.out_shardings)

    with mesh:
        train = jspecs.make_train_spec(jcfg, JInputShape("t", S, B, "train"),
                                       mesh)
        opt = joptim.adamw(LR)
        t_out = _np(jit(train)(params, opt.init(params), batch))
        prefill = jspecs.make_prefill_spec(
            jcfg, JInputShape("p", S, B, "prefill"), mesh)
        p_out = np.asarray(jit(prefill)(params, {"tokens": toks}))
        decode = jspecs.make_decode_spec(
            jcfg, JInputShape("d", DECODE_S, B, "decode"), mesh)
        # with its shardings JAX's decode spec does not trace on the
        # reference side (dynamic_update_slice of the cache sharded on the
        # Explicit "data" axis that jax.make_mesh gives, by an unsharded
        # row: R3's error); on one device they change no arithmetic
        step = jax.jit(decode.fn)
        state = model.init_decode_state(B, DECODE_S)
        d_out = []
        for pos in range(4):
            logits, state = step(params, state, toks[:, pos:pos + 1],
                                 jnp.int32(pos))
            d_out.append(np.asarray(logits))
    return _np(params), _np(batch), t_out, p_out, d_out


def _tparams(jparams):
    return bridge.zoo_params_from_numpy(jparams, "cpu")


def _tbatch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def test_train_spec_matches_jax_on_1x1():
    jparams, batch, (jp1, jstate, jloss), _, _ = _jax_runs()
    cfg = get_config("qwen3-0.6b").reduced()
    model = api.get_model(cfg)
    opt = specs.make_optimizer("qwen3-0.6b", LR)
    tb = _tbatch(batch)
    ref = _tparams(jparams)
    single = specs.make_train_step(model, opt)(ref, opt.init(ref), tb)
    with _group():
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
        spec = specs.make_train_spec(cfg, InputShape("t", S, B, "train"),
                                     mesh)
        params = _tparams(jparams)
        out = tdist.full_tree(tdist.apply_spec(spec, mesh, params,
                                               opt.init(params), tb))
    p1, state, loss = out
    _close(float(loss), float(jloss), "loss")
    # the spec's step is the single-device step's arithmetic
    assert float(loss) == float(single[2])
    for a, b in zip(tree_leaves(p1), tree_leaves(single[0])):
        assert torch.equal(a, b)
    mu = _paths(bridge.zoo_params_to_numpy(state["mu"]))
    jmu = _paths(jstate["mu"])
    got, want = _paths(bridge.zoo_params_to_numpy(p1)), _paths(jp1)
    assert sorted(got) == sorted(want) == sorted(mu)
    for name in want:
        scale = max(float(np.abs(jmu[name]).max()), 1e-30)
        assert np.abs(mu[name] - jmu[name]).max() <= GRAD_TOL * scale, name
        # AdamW's first step is lr g / (|g| + eps): entries whose gradient
        # (the first moment / 0.1) is near eps move by rounding of order lr
        big = np.abs(jmu[name]) >= 1e-3 * np.abs(jmu[name]).max()
        err = float(np.abs(got[name] - want[name])[big].max(initial=0.0))
        assert err <= STEP_TOL * LR, (name, err)


def test_prefill_and_decode_specs_match_jax_on_1x1():
    jparams, batch, _, jlogits, jdecode = _jax_runs()
    cfg = get_config("qwen3-0.6b").reduced()
    model = api.get_model(cfg)
    toks = _tbatch(batch)["tokens"]
    with _group(), torch.no_grad():
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
        params = _tparams(jparams)
        spec = specs.make_prefill_spec(cfg, InputShape("p", S, B, "prefill"),
                                       mesh)
        logits = tdist.full_tree(tdist.apply_spec(spec, mesh, params,
                                                  {"tokens": toks}))
        _close(logits, jlogits, "prefill logits")
        spec = specs.make_decode_spec(
            cfg, InputShape("d", DECODE_S, B, "decode"), mesh)
        assert spec.donate_argnums == (1,)
        state = model.init_decode_state(B, DECODE_S, device="cpu")
        for pos in range(4):
            out = tdist.apply_spec(spec, mesh, params, state,
                                   toks[:, pos:pos + 1],
                                   torch.tensor(pos, dtype=torch.int32))
            logits, state = tdist.full_tree(out)
            _close(logits, jdecode[pos], f"decode logits at {pos}")


# ---------------------------------------------------------------------------
# 2x2 threaded meshes
# ---------------------------------------------------------------------------


def _batch_2x2(cfg):
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, S), generator=g)
    return {"tokens": toks, "targets": torch.roll(toks, -1, 1)}


def test_train_spec_on_2x2_matches_single_device():
    """One AdamW step of the reduced qwen3 train spec on the 2x2 mesh
    against the single-device step: the loss within 1e-5, and the first
    moments (0.1 x the gradients) of each leaf within 1e-5 of the largest
    of any leaf (the parameters after AdamW's first step move by lr g /
    (|g| + eps), which rounding of a g near eps moves by order lr)."""
    cfg = get_config("qwen3-0.6b").reduced(scan_layers=True, n_layers=1,
                                           attn_chunk=32)
    model = api.get_model(cfg)
    batch = _batch_2x2(cfg)

    def fresh():
        return model.init(torch.Generator().manual_seed(0), "cpu")

    opt = specs.make_optimizer(cfg.arch_id)
    ref = fresh()
    _, want_state, want_loss = specs.make_train_step(model, opt)(
        ref, opt.init(ref), batch)

    def body(rank):
        mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
        spec = specs.make_train_spec(cfg, InputShape("t", S, 2, "train"),
                                     mesh)
        p = fresh()
        with tdist.collective_log() as log:
            out = tdist.apply_spec(spec, mesh, p, opt.init(p), batch)
        _, state, loss = tdist.full_tree(out)
        return float(loss), state, log.get_comm_counts()

    want = tree_leaves(want_state["mu"])
    top = max(float(m.abs().max()) for m in want)
    for rank, (loss, state, counts) in _threaded(4, body,
                                                 timeout=300).items():
        _close(loss, float(want_loss), f"rank {rank} loss")
        for got, m in zip(tree_leaves(state["mu"]), want):
            assert float((got - m).abs().max()) <= 1e-5 * top
        print("2x2 qwen3 train", rank, {str(k): v for k, v in counts.items()})
        assert sum(counts.values()) > 0


def test_fsdp_weight_gather_hook_on_2x2(monkeypatch):
    """The reduced gemma3 train spec under the "fsdp" rules with the
    weight-gather hook (gemma3 is in WEIGHT_GATHER_ARCHS) on the 2x2 mesh,
    against the same spec without the hook (on the 1x1 mesh, where it
    costs a second where a 2x2 run costs half a minute): the same loss
    within 1e-5, and the hooked step all-gathers every 2-D weight shape
    the hook names to its local size without the FSDP axis."""
    # one global layer: the hook, not the attention pattern, is under test
    # (DTensor's sharding propagation costs seconds a layer on 2x2)
    cfg = get_config("gemma3-12b").reduced(scan_layers=True, n_layers=1,
                                           global_every=0, window=None,
                                           attn_chunk=32)
    model = api.get_model(cfg)
    batch = _batch_2x2(cfg)
    shape = InputShape("t", S, 2, "train")
    rules = specs.rules_for(cfg.arch_id, shape)
    assert rules["embed"] == "data"

    def step(mesh):
        spec = specs.make_train_spec(cfg, shape, mesh)
        p = model.init(torch.Generator().manual_seed(0), "cpu")
        opt = specs.make_optimizer(cfg.arch_id)
        with tdist.collective_log() as log:
            out = tdist.apply_spec(spec, mesh, p, opt.init(p), batch)
        return float(tdist.full_tree(out)[2]), log.shapes

    with monkeypatch.context() as m, _group():
        m.setattr(specs, "WEIGHT_GATHER_ARCHS", set())
        want, _ = step(mesh_lib.make_debug_mesh(1, 1, device_type="cpu"))
    hooked = _threaded(4, lambda rank: step(mesh_lib.make_debug_mesh(
        2, 2, device_type="cpu")), timeout=300)
    shapes, axes = specs.abstract_init(model)

    def local(shape, pl):
        out = list(shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                out[p.dim] //= 2
        return tuple(out)

    with _group("fake", 4, FakeStore()):
        mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
        targets = specs.fsdp_gather_placements(shapes, axes, rules, mesh)
    # an all-gather along another dim than 0 gathers into dim 0 and is
    # re-cut: it is known by its element count
    named = {math.prod(local(s, pl)) for s, pl in targets.items()
             if len(s) == 2}
    assert named
    for rank, (loss, log) in hooked.items():
        _close(loss, want, f"rank {rank} loss")
        gathered = {math.prod(c.out_shape) for c in log
                    if c.name.startswith("all_gather")}
        assert named <= gathered, (rank, sorted(named - gathered))
