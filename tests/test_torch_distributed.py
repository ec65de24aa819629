"""The port's sharding rules, meshes, annotate hooks and distributed MDGNN
train spec (`nn/module.py`, `launch/mesh.py`, `train/annotate.py`,
`train/distributed.py`) against the JAX package on the CPU.

Process groups: a gloo group of world 1 over a `HashStore` for the 1x1
debug mesh (no socket); the threaded group of
`torch.testing._internal.distributed.multi_threaded_pg` (world 4, one
thread a rank, real collectives in one process) for the 2x2 mesh; a
`FakeStore` group of 256 or 512 ranks, which moves no data, for the
production meshes, where specs are only built. Every test tears its group
down, so later tests in the same worker see none.

Tolerances: the spec's steps on the 1x1 mesh against JAX's spec run
(`jax.jit` with the spec's shardings) as tests/test_torch_train.py holds
the lag-one step: loss 1e-5 relative, memory table and parameters 1e-5
after one step and 1e-4 after three, trackers 1e-4, last-update times and
rings exact; the 2x2 sharded step and the `optimized` strategy against
the port's own single-device step, loss and table 1e-5."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.graph import datasets as jdatasets
from repro.graph.negatives import sample_negatives_in as jsample_in
from repro.launch import mesh as jmesh_lib
from repro.models import mdgnn as jmdgnn
from repro.nn import module as jmodule
from repro.optim import optimizers as joptim
from repro.train import distributed as jdistributed
from repro.train import pipeline as jpipeline

from repro_torch import bridge
from repro_torch.configs import tgn_pres
from repro_torch.graph import events as tevents
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.nn import module as tmodule
from repro_torch.optim import optimizers as toptim
from repro_torch.train import annotate
from repro_torch.train import distributed as tdist
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline

B = 50                 # temporal batch size on the 300-event tiny stream


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _group(backend="gloo", world=1, store=None):
    """A process group of rank 0 for the block, destroyed after it."""
    assert not dist.is_initialized()
    dist.init_process_group(backend, store=store or dist.HashStore(),
                            rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _threaded(world, fn, timeout=120.0):
    """fn(rank) on `world` threads of a threaded process group; returns
    {rank: result}. Fails when a rank raises or runs past `timeout`."""
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg, _uninstall_threaded_pg)
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    store = dist.HashStore()
    results, errors = {}, []

    def worker(rank):
        dist.init_process_group("threaded", rank=rank, world_size=world,
                                store=store)
        try:
            results[rank] = fn(rank)
        except BaseException as exc:        # reported below, in the test
            errors.append((rank, exc))
            ProcessLocalGroup.exception_handle(exc)
        finally:
            dist.destroy_process_group()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        alive = [t for t in threads if t.is_alive()]
    finally:
        ProcessLocalGroup.reset()
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    assert not alive, f"{len(alive)} rank(s) ran past {timeout} s"
    if errors:
        raise errors[0][1]
    return results


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

AXES = [("batch", "seq"), ("embed", "mlp"), ("vocab", "embed"),
        ("nodes", "embed"), ("nodes", None, "embed"), ("nodes",),
        ("event",), ("event", None), (None, "event"), (None, "event", None),
        ("mlp", "mlp"), ("mlp", None), (None, "embed"), (None,), (),
        ("heads", "kv_heads", "head_dim"), ("expert", "embed", "expert_mlp"),
        ("layers", "embed", "mlp"), ("batch", "cache_seq", "kv_heads"),
        ("embed", "embed"), ("unknown", "mlp"), None]
MESH_NAMES = [("data", "model"), ("pod", "data", "model")]


@pytest.mark.parametrize("names", MESH_NAMES, ids=lambda n: "x".join(n))
@pytest.mark.parametrize("rule_set", sorted(jmodule.RULE_SETS))
def test_logical_to_spec_matches_jax(rule_set, names):
    rules_t = tmodule.RULE_SETS[rule_set]
    rules_j = jmodule.RULE_SETS[rule_set]
    assert rules_t == rules_j
    for axes in AXES:
        got = tmodule.logical_to_spec(axes, rules_t, names)
        want = jmodule.logical_to_spec(axes, rules_j, names)
        assert tuple(got) == tuple(want), (axes, got, want)


def test_jax_rule_checks_hold_on_the_port():
    """JAX tests/test_distributed.py:27-50 on the port's rules."""
    names = ("data", "model")
    rules = dict(tmodule.DEFAULT_RULES)
    assert tmodule.logical_to_spec(("batch", "seq"), rules, names) == \
        tmodule.P("data")
    assert tmodule.logical_to_spec(("embed", "mlp"), rules, names) == \
        tmodule.P(None, "model")
    assert tmodule.logical_to_spec(("vocab", "embed"), rules, names) == \
        tmodule.P("model")
    assert tmodule.logical_to_spec(("embed", "mlp"), tmodule.FSDP_RULES,
                                   names) == tmodule.P("data", "model")
    assert set(tmodule.RULE_SETS) >= {"default", "fsdp", "long_ctx"}
    assert tmodule.RULE_SETS["long_ctx"]["cache_seq"] == "model"


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    three = ("pod", "data", "model")
    spec = tmodule.logical_to_spec(("nodes", None, "embed"),
                                   tmodule.DEFAULT_RULES, three)
    assert spec == tmodule.P(("pod", "data"))
    assert tmodule.spec_to_placements(spec, three) == (
        Shard(0), Shard(0), Replicate())
    fsdp = tmodule.logical_to_spec(("embed", "mlp"), tmodule.FSDP_RULES,
                                   ("data", "model"))
    assert tmodule.spec_to_placements(fsdp, ("data", "model")) == (
        Shard(0), Shard(1))
    assert tmodule.spec_to_placements(tmodule.P(), ("data", "model")) == (
        Replicate(), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tmodule.spec_to_placements(tmodule.P(("model", "data")),
                                   ("data", "model"))


# ---------------------------------------------------------------------------
# The axes trees
# ---------------------------------------------------------------------------


def _norm(tree):
    """Dataclass nodes as dicts of their fields, so both packages' trees
    compare leaf for leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _norm(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tree


def test_state_axes_match_jax():
    from repro.core import batching as jbatching
    from repro.core import pres as jpres
    from repro.models import modules as jmodules
    from repro_torch.core import batching as tbatching
    from repro_torch.core import pres as tpres
    from repro_torch.models import modules as tmodules
    assert _norm(tmdgnn.STATE_AXES) == _norm(jmdgnn.STATE_AXES)
    assert _norm(tmodules.MEMORY_STATE_AXES) == \
        _norm(jmodules.MEMORY_STATE_AXES)
    assert tbatching.NEIGHBOR_AXES == jbatching.NEIGHBOR_AXES
    assert _norm(tpres.PRES_STATE_AXES) == _norm(jpres.PRES_STATE_AXES)
    assert _norm(tpipeline.PIPELINE_STATE_AXES) == \
        _norm(jpipeline.PIPELINE_STATE_AXES)


def _ranks(tree, path=""):
    """{leaf path: its length} of a tree of axes tuples or shapes."""
    if not isinstance(tree, dict):
        return {path: len(tree)}
    return {k: v for kk, vv in tree.items()
            for k, v in _ranks(vv, f"{path}/{kk}").items()}


VARIANTS = {
    "tgn": dict(variant="tgn"),
    "dense": dict(variant="tgn", dedup_embed=False),
    "apan": dict(variant="apan"),
    "jodie": dict(variant="jodie"),
    "rnn": dict(variant="tgn", memory_cell="rnn", n_layers=1),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_param_axes_match_jax(name):
    kw = dict(n_nodes=20, d_edge=4, d_mem=8, d_msg=8, d_time=4,
              d_embed=8, n_layers=2)
    kw.update(VARIANTS[name])
    jcfg = jmdgnn.MDGNNConfig(**kw)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    _, jaxes = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    taxes = tmdgnn.param_axes(tcfg)
    assert taxes == jaxes
    shapes = tmdgnn.param_shapes(tcfg)
    tmodule.map_axes(lambda ax: ax, taxes)      # every leaf an axes tuple
    assert _ranks(taxes) == _ranks(shapes)
    # the AdamW state's axes
    assert toptim.adamw(1e-3).state_axes(taxes) == \
        joptim.adamw(1e-3).state_axes(jaxes)
    # and their specs on both meshes' names
    for names in MESH_NAMES:
        mesh_t = types.SimpleNamespace(mesh_dim_names=names)
        mesh_j = types.SimpleNamespace(axis_names=names)
        for rs in ("default", "fsdp", "mdgnn_event_dp"):
            got = tmodule.tree_specs(taxes, tmodule.RULE_SETS[rs], mesh_t)
            want = jmodule.tree_specs(jaxes, jmodule.RULE_SETS[rs], mesh_j)
            assert jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)) == tmodule.map_axes(
                    tuple, got)


# ---------------------------------------------------------------------------
# The hooks
# ---------------------------------------------------------------------------


def test_hooks_are_identity_without_install():
    x = torch.arange(6.0)
    assert annotate.compact(x) is x
    assert annotate.events(x) is x
    assert annotate.weights(x) is x
    assert annotate.local(lambda a: a, x) is x
    out = annotate.local(lambda a, b, k=0: (a, b, k), x, "s", k=3)
    assert out[0] is x and out[1:] == ("s", 3)
    # writes= on plain tensors: fn runs on the caller's own tensors
    annotate.local(lambda t: t.add_(1.0), x, writes=(0,))
    assert torch.equal(x, torch.arange(6.0) + 1.0)


def test_install_nests_restores_and_is_thread_local():
    x = torch.zeros(2)
    f1, f2 = (lambda t: t + 1), (lambda t: t + 2)
    g = lambda t: t - 1
    seen = {}
    with annotate.install(compact_fn=f1):
        assert torch.equal(annotate.compact(x), x + 1)
        with annotate.install(compact_fn=f2, events_fn=g):
            assert torch.equal(annotate.compact(x), x + 2)
            assert torch.equal(annotate.events(x), x - 1)
            th = threading.Thread(target=lambda: seen.update(
                c=annotate.compact(x), e=annotate.events(x)))
            th.start()
            th.join()
        assert torch.equal(annotate.compact(x), x + 1)
        assert annotate.events(x) is x
    assert annotate.compact(x) is x
    assert seen["c"] is x and seen["e"] is x
    with pytest.raises(RuntimeError):
        with annotate.install(weights_fn=f1):
            raise RuntimeError("body fails")
    assert annotate.weights(x) is x


def test_local_on_dtensors_replicates_and_writes_back():
    """On a 2x2 mesh: a Shard(0) argument reaches fn whole, results come
    back replicated, and a written argument's shards take the write."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    def body(rank):
        mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
        full = torch.arange(10.0)
        tab = distribute_tensor(full.clone(), mesh, [Shard(0), Replicate()],
                                src_data_rank=None)
        seen = annotate.local(lambda t: t.clone(), tab)
        assert isinstance(seen, DTensor)
        assert seen.placements == (Replicate(), Replicate())

        def write(t, idx):
            t[idx] = -1.0

        annotate.local(write, tab, torch.tensor([0, 9]), writes=(0,))
        want = full.clone()
        want[[0, 9]] = -1.0
        return (seen.to_local().clone(), tab.full_tensor(), want)

    for seen, got, want in _threaded(4, body, timeout=60).values():
        assert torch.equal(seen, torch.arange(10.0))
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The spec on a 1x1 debug mesh, against JAX's spec run
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _stream():
    return jdatasets.generate(jdatasets.SyntheticSpec("tiny", 30, 20, 300, 4),
                              seed=0)


def _jcfg(variant, **kw):
    s = _stream()
    base = dict(variant="tgn", n_nodes=s.num_nodes, d_edge=s.feat_dim,
                d_mem=8, d_msg=8, d_time=4, d_embed=8, n_neighbors=4,
                use_pres=True, use_kernels=True)
    if variant == "pipe":
        base["pipeline_depth"] = 2
    if variant == "scan":
        base["scan_chunk"] = 3
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jstate_np(state):
    return {"memory": {"mem": np.asarray(state["memory"].mem),
                       "last_update": np.asarray(state["memory"].last_update)},
            "neighbors": {k: np.asarray(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.asarray(state["pres"].n),
                     "xi": np.asarray(state["pres"].xi),
                     "psi": np.asarray(state["pres"].psi)}}


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.asarray(jb.src), np.asarray(jb.dst), np.asarray(jb.t),
        np.asarray(jb.feat), np.asarray(jb.mask), "cpu")


def _close(got, want, tol, what, floor=1.0):
    """|got - want| <= tol * max(floor, max|want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = tol * max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _assert_params(tp, jp, tol, path="", floor=1.0):
    if isinstance(jp, dict):
        for k in jp:
            _assert_params(tp[k], jp[k], tol, f"{path}/{k}", floor)
    else:
        _close(tp.detach().numpy(), jp, tol, f"param {path}", floor)


def _assert_state(ts, js, tol):
    a, b = bridge.state_to_numpy(ts), _jstate_np(js)
    for k in ("nbr", "t", "ptr"):
        np.testing.assert_array_equal(a["neighbors"][k], b["neighbors"][k])
    np.testing.assert_array_equal(a["memory"]["last_update"],
                                  b["memory"]["last_update"])
    np.testing.assert_array_equal(a["pres"]["n"], b["pres"]["n"])
    _close(a["memory"]["mem"], b["memory"]["mem"], tol, "memory table")
    for k in ("xi", "psi"):
        _close(a["pres"][k], b["pres"][k], 1e-4, f"tracker {k}")


@functools.lru_cache(maxsize=None)
def _jax_spec_run(variant, strategy):
    """JAX's spec of `variant` run 3 steps with jax.jit and the spec's
    shardings on its own 1x1 mesh (as tests/test_distributed.py:56-78
    lowers it). Returns the JAX start, the losses, the numpy carry after
    steps 1 and 3, and the negatives it scored."""
    jcfg = _jcfg(variant)
    mesh = jmesh_lib.make_debug_mesh(1, 1)
    spec = jdistributed.make_mdgnn_train_spec(jcfg, B, mesh,
                                              strategy=strategy)
    jitted = jax.jit(spec.fn, in_shardings=spec.in_shardings,
                     out_shardings=spec.out_shardings)
    params, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    opt = joptim.adamw(1e-3)
    opt_state, state = opt.init(params), jmdgnn.init_state(jcfg)
    batches = list(_stream().temporal_batches(B))
    start = (_np(params), _jstate_np(state))
    losses, carries, negs = [], {}, []
    with mesh:
        if variant == "scan":
            key = jax.random.PRNGKey(1)
            macro = jax.tree.map(lambda *x: jnp.stack(x), *batches[:4])
            k = key
            for i in range(3):   # the macro step's own key splits
                k, sub = jax.random.split(k)
                negs.append(jsample_in(sub, batches[i + 1], 0, jcfg.n_nodes))
            out = jitted(params, opt_state, state, key, macro)
            losses.append(float(out[-1]))
            carries[3] = _np(out[:3])
        else:
            pstate = (jpipeline.PipelineState.init(state["memory"])
                      if variant == "pipe" else None)
            for i in range(3):
                # negatives: the positives with their destinations rolled
                neg = dataclasses.replace(batches[i + 1], dst=jnp.roll(
                    batches[i + 1].dst, 7))
                negs.append(neg)
                args = (params, opt_state, state) + (
                    (pstate,) if pstate is not None else ()) + (
                    batches[i], batches[i + 1], neg)
                out = _np(jitted(*args))
                params, opt_state, state = out[:3]
                if pstate is not None:
                    pstate = out[3]
                losses.append(float(out[-1]))
                carries[i + 1] = out[:3]
    return jcfg, start, batches, negs, losses, carries


@pytest.mark.parametrize("variant", ["lag", "pipe", "scan"])
@pytest.mark.parametrize("strategy", ["gspmd", "compact_update"])
def test_spec_steps_match_jax_debug_mesh(strategy, variant):
    """Three applied steps (one macro step of three for "scan") against
    JAX's spec run. JAX's compact_update spec does not trace on the
    reference side: its hook's with_sharding_constraint names the
    Explicit axes that `jax.make_mesh` gives (the error of R3,
    src/repro/train/distributed.py:200). On a 1x1 mesh the shardings and
    hooks change no arithmetic, so the port's compact_update steps are held
    against JAX's gspmd run."""
    jcfg, (jp0, js0), batches, negs, jlosses, jcarry = _jax_spec_run(
        variant, "gspmd")
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    with _group():
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
        spec = tdist.make_mdgnn_train_spec(tcfg, B, mesh, strategy=strategy)
        assert spec.donate_argnums == ((1, 2, 3) if variant == "pipe"
                                       else (1, 2))
        params = bridge.params_from_numpy(jp0, "cpu")
        opt = toptim.adamw(1e-3)
        opt_state = opt.init(params)
        state = bridge.state_from_numpy(js0, "cpu")
        tb = [_tbatch(b) for b in batches[:4]]
        tn = [_tbatch(n) for n in negs]
        if variant == "scan":
            out = tdist.apply_spec(spec, mesh, params, opt_state, state,
                                   torch.Generator().manual_seed(1),
                                   tevents.stack_batches(tb), negatives=tn)
            out = tdist.full_tree(out)
            _close(float(out[-1]["loss"]), jlosses[0], 1e-5, "mean loss")
            checks = {3: out}
        else:
            pstate = (tpipeline.PipelineState.init(state["memory"])
                      if variant == "pipe" else None)
            checks = {}
            for i in range(3):
                args = (params, opt_state, state) + (
                    (pstate,) if pstate is not None else ()) + (
                    tb[i], tb[i + 1], tn[i])
                out = tdist.apply_spec(spec, mesh, *args)
                params, opt_state, state = out[:3]
                if pstate is not None:
                    pstate = out[3]
                full = tdist.full_tree(out)
                _close(float(full[-1]["loss"]), jlosses[i], 1e-5,
                       f"loss step {i + 1}")
                checks[i + 1] = full
    single = _port_single_device(tcfg, variant, jp0, js0, tb, tn)
    for n, tol in ((1, 1e-5), (3, 1e-4)):
        if n not in checks:
            continue
        tp, tos, ts = checks[n][:3]
        jp, jos, js = jcarry[n]
        _assert_state(ts, js, tol)
        # the first moments against JAX, as one vector (test_torch_jodie.py);
        # the parameters against the port's single-device step: an element
        # whose gradient is far below AdamW's eps (emb/l0/wo here, 2.3e-10)
        # moves by lr g / (|g| + eps), g's rounding of its own size, and
        # the single-device step already puts it 2.7e-5 from JAX's
        top = max(float(np.abs(np.asarray(m)).max())
                  for m in jax.tree.leaves(jos["mu"]))
        _assert_params(tos["mu"], jos["mu"], tol, floor=top)
        _assert_params(tp, _np_torch(single[n][0]), tol)
        _assert_params(tos["mu"], _np_torch(single[n][1]["mu"]), tol)


def _np_torch(tree):
    return {k: _np_torch(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _port_single_device(cfg, variant, jp0, js0, tb, tn):
    """The port's own engine from the same start: {n: (params, opt_state)}
    after steps 1 and 3 (after the macro step for "scan")."""
    from repro_torch.train import scan as tscan
    params = bridge.params_from_numpy(jp0, "cpu")
    opt = toptim.adamw(1e-3)
    opt_state, state = opt.init(params), bridge.state_from_numpy(js0, "cpu")
    clone = lambda t: annotate.map_tensors(lambda x: x.detach().clone(), t)
    if variant == "scan":
        step = tscan.make_macro_step(cfg, opt, (0, cfg.n_nodes))
        p, o, _, _ = step(params, opt_state, state, None,
                          tevents.stack_batches(tb), negatives=tn)
        return {3: (clone(p), clone(o))}
    out = {}
    if variant == "pipe":
        pstate = tpipeline.PipelineState.init(state["memory"])
        step = tpipeline.make_pipelined_train_step(cfg, opt)
    else:
        step = tloop.make_train_step(cfg, opt)
    for i in range(3):
        args = ((pstate,) if variant == "pipe" else ()) + (
            tb[i], tb[i + 1], tn[i])
        params, opt_state, state, *_ = step(params, opt_state, state, *args)
        out[i + 1] = (clone(params), clone(opt_state))
    return out


def test_optimized_spec_matches_single_device_step():
    """The `optimized` strategy (replicated parameters and state, event
    data parallelism, hashed trackers, a bf16 table). Its JAX spec does
    not build on the reference side (tests/test_distributed.py:181,
    ROADMAP Queue 3 R3), so it is held against the port's own
    single-device step."""
    jcfg = _jcfg("lag", pres_buckets=16, mem_dtype="bfloat16")
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    rules = dict(tmodule.RULE_SETS["mdgnn_event_dp_repl"])
    batches = [_tbatch(b) for b in list(_stream().temporal_batches(B))[:4]]
    negs = [dataclasses.replace(b, dst=torch.roll(b.dst, 7))
            for b in batches]

    def carry():
        params = tmdgnn.init_params(tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt = toptim.adamw(1e-3)
        return params, opt.init(params), tmdgnn.init_state(tcfg, "cpu"), opt

    p, o, s, opt = carry()
    step = tloop.make_train_step(tcfg, opt)
    want = []
    for i in range(3):
        p, o, s, m = step(p, o, s, batches[i], batches[i + 1], negs[i + 1])
        want.append(float(m["loss"]))
    with _group():
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
        spec = tdist.make_mdgnn_train_spec(tcfg, B, mesh, rules=rules,
                                           strategy="optimized")
        p2, o2, s2, _ = carry()
        for i in range(3):
            p2, o2, s2, m2 = tdist.apply_spec(spec, mesh, p2, o2, s2,
                                              batches[i], batches[i + 1],
                                              negs[i + 1])
            _close(float(m2["loss"].full_tensor()), want[i], 1e-5,
                   f"loss step {i + 1}")
        table = tdist.full_tree(s2)["memory"].mem
    assert table.dtype == torch.bfloat16
    _close(table.float().numpy(), s["memory"].mem.float().numpy(), 1e-5,
           "bf16 memory table")


@pytest.mark.parametrize("kw", [dict(use_pres=False),
                                dict(memory_cell="rnn")],
                         ids=["alg1", "rnn-pres"])
def test_cell_route_spec_matches_single_device_step(kw):
    """The cell routes (Alg. 1: the GRU cell; the rnn cell with PRES
    through pres_filter), whose table and time writes
    (`batching.write_selected`) run inside `annotate.local`: three spec
    steps on the 1x1 mesh against the port's single-device step, loss and
    memory table within 1e-5, last_update exact."""
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(_jcfg("lag", **kw)))
    batches = [_tbatch(b) for b in list(_stream().temporal_batches(B))[:4]]
    negs = [dataclasses.replace(b, dst=torch.roll(b.dst, 7))
            for b in batches]

    def carry():
        params = tmdgnn.init_params(tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt = toptim.adamw(1e-3)
        return params, opt.init(params), tmdgnn.init_state(tcfg, "cpu"), opt

    p, o, s, opt = carry()
    step = tloop.make_train_step(tcfg, opt)
    want = []
    for i in range(3):
        p, o, s, m = step(p, o, s, batches[i], batches[i + 1], negs[i + 1])
        want.append(float(m["loss"]))
    with _group():
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
        spec = tdist.make_mdgnn_train_spec(tcfg, B, mesh)
        p2, o2, s2, _ = carry()
        for i in range(3):
            p2, o2, s2, m2 = tdist.apply_spec(spec, mesh, p2, o2, s2,
                                              batches[i], batches[i + 1],
                                              negs[i + 1])
            _close(float(m2["loss"].full_tensor()), want[i], 1e-5,
                   f"loss step {i + 1}")
        mem = tdist.full_tree(s2)["memory"]
    _close(mem.mem.numpy(), s["memory"].mem.numpy(), 1e-5, "memory table")
    assert torch.equal(mem.last_update, s["memory"].last_update)


# ---------------------------------------------------------------------------
# A 2x2 mesh on the threaded process group
# ---------------------------------------------------------------------------


def _small_cfg(**kw):
    base = dict(variant="tgn", n_nodes=50, d_edge=4, d_mem=8, d_msg=8,
                d_time=4, d_embed=8, n_neighbors=4, use_pres=True,
                use_kernels=True)
    base.update(kw)
    return tmdgnn.MDGNNConfig(**base)


def _small_batches(n, b=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        out.append(tevents.EventBatch(
            src=torch.randint(0, 25, (b,), generator=g),
            dst=torch.randint(25, 50, (b,), generator=g),
            t=torch.sort(torch.rand(b, generator=g) * 100).values,
            feat=torch.randn(b, 4, generator=g),
            mask=torch.rand(b, generator=g) < 0.9))
    return out


def _steps(cfg, step, carry, batches, negs, n_steps, log=None):
    """n_steps of `step` (the lag-one or the pipelined signature) from
    `carry`; returns (losses, carry, collective counts of each step)."""
    losses, logs = [], []
    for i in range(n_steps):
        with (log() if log else contextlib.nullcontext()) as comm:
            out = step(*carry, batches[i], batches[i + 1], negs[i + 1])
        carry, m = out[:-1], out[-1]
        if comm is not None:
            logs.append((dict(comm.get_comm_counts()), list(comm.shapes)))
        loss = m["loss"]
        losses.append(float(loss.full_tensor() if annotate.is_dtensor(loss)
                            else loss))
    return losses, carry, logs


def _start(cfg):
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = toptim.adamw(1e-3)
    carry = (params, opt.init(params), tmdgnn.init_state(cfg, "cpu"))
    if cfg.pipeline_depth:
        carry += (tpipeline.PipelineState.init(carry[2]["memory"]),)
    return carry, opt


def _single_device(cfg, batches, negs, n_steps):
    carry, opt = _start(cfg)
    losses, carry, _ = _steps(cfg, tpipeline.make_train_step(cfg, opt), carry,
                              batches, negs, n_steps)
    return losses, carry[2]


def _spec_on_2x2(cfg, strategy, batches, negs, n_steps, rules=None):
    """Each rank applies the spec n_steps times from the seeded start;
    returns {rank: (losses, full memory table, collective log entries of
    every step)}."""
    def body(rank):
        mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
        spec = tdist.make_mdgnn_train_spec(cfg, 20, mesh, rules=rules,
                                           strategy=strategy)
        carry, _ = _start(cfg)
        losses, carry, logs = _steps(
            cfg, functools.partial(tdist.apply_spec, spec, mesh), carry,
            batches, negs, n_steps, log=tdist.collective_log)
        return losses, tdist.full_tree(carry[2])["memory"].mem, logs

    return _threaded(4, body, timeout=120)


def _table_sized(shapes, cfg):
    """The all-reduces of the memory table's (N, D) shape, with whether
    the backward issued each."""
    return [(s[1], s[2]) for s in shapes if s[0] == "all_reduce"
            and s[1] == (cfg.n_nodes, cfg.d_mem)]


@pytest.mark.parametrize("depth", [0, 2], ids=["lag", "pipe"])
def test_gspmd_spec_on_2x2_matches_single_device(depth):
    """Two gspmd steps on the 2x2 mesh (the lag-one step, and the
    pipelined one, whose snapshot and in-flight counts are node-sharded
    with the rows' dump row: uneven shards) against the single-device
    steps."""
    cfg = _small_cfg(pipeline_depth=depth)
    batches, negs = _small_batches(4), _small_batches(4, seed=1)
    want, s = _single_device(cfg, batches, negs, 2)
    for rank, (losses, table, logs) in _spec_on_2x2(
            cfg, "gspmd", batches, negs, 2).items():
        print("gspmd", depth, rank, [
            ({str(k): v for k, v in c.items()}, _table_sized(sh, cfg))
            for c, sh in logs])
        for i in range(2):
            _close(losses[i], want[i], 1e-5, f"rank {rank} loss {i + 1}")
        _close(table.numpy(), s["memory"].mem.numpy(), 1e-5,
               f"rank {rank} memory table")


@pytest.mark.parametrize("strategy", ["compact_update", "optimized"])
def test_collectives_on_2x2(strategy):
    """One step of each other strategy on the 2x2 mesh (gspmd's are the
    test above), against the single-device loss. The collective counts
    are findings (PERF.md; `-s` prints them); the one count the
    JAX docstring states (src/repro/train/distributed.py:78-84) is
    asserted: the compact_update step all-reduces nothing of the memory
    table's size."""
    cfg = _small_cfg()
    rules = (dict(tmodule.RULE_SETS["mdgnn_event_dp_repl"])
             if strategy == "optimized" else None)
    batches, negs = _small_batches(3), _small_batches(3, seed=1)
    want, _ = _single_device(cfg, batches, negs, 1)
    out = _spec_on_2x2(cfg, strategy, batches, negs, 1, rules=rules)
    for rank, (losses, _, logs) in out.items():
        _close(losses[0], want[0], 1e-5, f"rank {rank} loss")
        counts, shapes = logs[0]
        big = _table_sized(shapes, cfg)
        print(strategy, rank, {str(k): v for k, v in counts.items()}, big)
        assert sum(counts.values()) > 0      # a 2x2 step communicates
        if strategy == "compact_update":
            assert not big, big


# ---------------------------------------------------------------------------
# The production meshes, over a fake process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["256", "512"])
def test_production_mesh_and_spec(multi_pod):
    """JAX tests/test_distributed.py:282's shape contract, built for real
    here: the mesh over a FakeStore group, and tgn_pres.PRODUCTION's spec
    on meta arguments (nothing executes). The memory table's local shard
    is 1,048,576 / 16 rows on (16, 16) ("pod" and "data" share "nodes":
    / 32 on (2, 16, 16)). The rings' dump row makes their shards uneven
    where JAX's are even (ROADMAP Queue 3)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if multi_pod else 256
    with _group("fake", world, FakeStore()):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        cfg = tgn_pres.PRODUCTION
        spec = tdist.make_mdgnn_train_spec(cfg, 1000, mesh)
        n = cfg.n_nodes
        assert n == 1_048_576
        rows = n // (32 if multi_pod else 16)

        def local(arg, shard):
            assert arg.device.type == "meta"
            return tuple(distribute_tensor(arg, mesh, list(shard),
                                           src_data_rank=None)
                         .to_local().shape)

        st, sh = spec.args[2], spec.in_shardings[2]
        assert local(st["memory"].mem, sh["memory"].mem) == (rows, cfg.d_mem)
        assert local(st["memory"].last_update,
                     sh["memory"].last_update) == (rows,)
        # N + 1 rows: rank 0's shard holds one row more than JAX's
        assert local(st["neighbors"]["nbr"], sh["neighbors"]["nbr"]) == (
            rows + 1, cfg.n_neighbors)
        # the events: 1,000 over 16 (or 32) ranks
        ev = spec.args[3].src
        assert local(ev, spec.in_shardings[3].src) == (
            -(-1000 // (32 if multi_pod else 16)),)
        # "mlp" over "model": the message MLP's columns split 16 ways
        w1 = spec.args[0]["msg"]["w1"]
        assert local(w1, spec.in_shardings[0]["msg"]["w1"]) == (
            w1.shape[0], cfg.d_msg // 16)
    assert not dist.is_initialized()


def test_mesh_needs_a_matching_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
    with _group():
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
        with pytest.raises(ValueError, match="unknown strategy"):
            tdist.make_mdgnn_train_spec(_small_cfg(), 20,
                                        mesh_lib.make_debug_mesh(
                                            1, 1, device_type="cpu"),
                                        strategy="nope")


def test_h100_roofline_constants():
    assert mesh_lib.PEAK_FLOPS_BF16 == 989e12
    assert mesh_lib.HBM_BW == 3.35e12
    assert mesh_lib.NVLINK_BW == 900e9
