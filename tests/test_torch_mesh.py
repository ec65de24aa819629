"""Memory-parallel training and bf16 memory tables in the port, on the CPU.

Whole engines at several shard counts are held to the port's own
n_shards = 1 run of the same workload (`train/mesh_check.py`: one
synthetic stream, one set of initial parameters and negatives), every
state leaf and the train AP within ATOL = 1e-5 (JAX's mesh suite,
tests/test_distributed_mesh.py): the sequential engine at 2, 4 and 8
shards (and its plain route at 4), the pipelined engine (depth 2) and the
scan engine (chunk 2) at 4, APAN and JODIE at 4; `evaluate` after a
sharded epoch; the train CLI with `--n-shards 4 --device cpu`, whose
checkpoint (the natural layout) an unsharded serve restores, and a tight
`--shard-budget` whose overflow the run-log reports by shard. One process
drives every shard, so nothing here spawns a subprocess.

bf16 memory tables (`mem_dtype="bfloat16"`): JAX's
`test_bf16_memory_table_trains` carried over; 1 and 3 train steps
against JAX's bf16 run with JAX's negatives injected (the table rows
within one bf16 ulp plus the train tolerance, parameters within the
train tolerance); the table kernel's plain version on a bf16 table and
the dense op on bf16 rows against JAX's Pallas kernels in interpret
mode; bf16 checkpoint leaves in JAX's file format both ways."""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.checkpoint import io as jio
from repro.graph import datasets as jdatasets
from repro.graph.negatives import sample_negatives as jsample
from repro.kernels import memory_update as jmu
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.train import loop as jloop
from repro.train import mesh_check as jmesh_check
from repro.train import routing as jrouting

from repro_torch import bridge
from repro_torch.checkpoint import io as tio
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph import events as tevents
from repro_torch.graph.negatives import sample_negatives as tsample
from repro_torch.kernels import ref as tref
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import loop as tloop
from repro_torch.train import mesh_check as tmesh_check
from repro_torch.train import routing as trouting

ATOL = 1e-5


# ---------------------------------------------------------------------------
# whole engines against the port's own single-shard run
# ---------------------------------------------------------------------------


def _mesh_run(tmp_path, use_kernels=True, **flags):
    """mesh_check's run on the CPU: (its report, the final state)."""
    out = tmp_path / ("run_" + "_".join(f"{k}{v}" for k, v in flags.items())
                      + f"_k{int(use_kernels)}.npz")
    argv = ["--device", "cpu", "--out", str(out)]
    argv += ["--use-kernels"] if use_kernels else []
    for k, v in flags.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    report = tmesh_check.run(tmesh_check.build_argparser().parse_args(argv))
    return report, dict(np.load(out))


ENGINES = [
    dict(engine="sequential", n_shards=2),
    dict(engine="sequential", n_shards=4),
    dict(engine="sequential", n_shards=8),
    dict(engine="sequential", n_shards=4, use_kernels=False),
    dict(engine="pipelined", n_shards=4),
    dict(engine="scanned", n_shards=4),
    dict(engine="sequential", n_shards=4, variant="apan"),
    dict(engine="sequential", n_shards=4, variant="jodie"),
]


@pytest.mark.parametrize("flags", ENGINES, ids=[
    "-".join(str(v) for v in f.values()) for f in ENGINES])
def test_sharded_engine_matches_single_shard(tmp_path, flags):
    base = dict(flags, n_shards=1)
    rep1, st1 = _mesh_run(tmp_path, **base)
    rep, st = _mesh_run(tmp_path, **flags)
    assert st.keys() == st1.keys()
    for k in st1:
        np.testing.assert_allclose(st[k].astype(np.float64),
                                   st1[k].astype(np.float64), atol=ATOL,
                                   err_msg=k)
    assert abs(rep["ap"] - rep1["ap"]) <= ATOL
    assert rep["route_overflow"] == rep1["route_overflow"] == 0
    assert rep["devices"] == 1


def test_mesh_check_state_names_are_jax(tmp_path):
    """The npz names are those of JAX's runner for the same state."""
    jcfg = jmdgnn.MDGNNConfig(variant="apan", n_nodes=9, d_edge=2, d_mem=4,
                              d_msg=4, d_embed=4)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    assert sorted(tmesh_check.flat_state(tmdgnn.init_state(tcfg, "cpu"))) \
        == sorted(jmesh_check._flat_state(jmdgnn.init_state(jcfg)))


def test_tight_budget_epoch_counts_overflow(tmp_path):
    """An epoch's route_overflow is the sum over its steps of JAX's plan of
    the same occurrences."""
    budget, n = 4, 4
    rep, _ = _mesh_run(tmp_path, n_shards=n, shard_budget=budget)
    spec = jdatasets.SyntheticSpec("mesh", 50, 30, 300, 8)
    batches = jdatasets.generate(spec, seed=0).temporal_batches(75)
    want = 0
    for b in batches[:-1]:
        nodes, _, _, _, mask, _, _ = jrouting._padded_occurrences(b, n)
        ms = nodes.shape[0] // n
        want += sum(int(jrouting.bucket_plan(
            jnp.clip(nodes[s * ms:(s + 1) * ms], 0, spec.n_users
                     + spec.n_items - 1) % n,
            mask[s * ms:(s + 1) * ms], n, budget)[3]) for s in range(n))
    assert rep["route_overflow"] == want > 0


@pytest.mark.parametrize("use_pres", [True, False], ids=["fused", "cell"])
def test_sharded_step_leaves_no_graph_on_the_tables(use_pres):
    """After a sharded train step neither the returned tables nor the
    caller's carry hold an autograd graph: the fused route's tables, which
    the kernel writes in place, are detached in place, so a captured
    macro step (train/scan.py) can hand the caller's carry to the next
    capture."""
    spec = tdatasets.SyntheticSpec("dt", 20, 10, 120, 4)
    stream = tdatasets.generate(spec, seed=0)
    cfg = tmdgnn.MDGNNConfig(variant="tgn", n_nodes=stream.num_nodes,
                             d_edge=4, d_mem=8, d_msg=8, d_time=4,
                             d_embed=8, n_neighbors=4, use_pres=use_pres,
                             use_kernels=True, n_shards=2)
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = trouting.shard_state(cfg, tmdgnn.init_state(cfg, "cpu"),
                                 trouting.get_mesh(2, "cpu"))
    opt = toptim.adamw(1e-3)
    b = stream.temporal_batches(40, "cpu")
    neg = tsample(torch.Generator().manual_seed(1), b[1], 20, 30)
    _, _, out, _ = tloop.make_train_step(cfg, opt)(
        params, opt.init(params), state, b[0], b[1], neg)
    for st in (state, out):
        for t in st["memory"].mem + st["memory"].last_update:
            assert not t.requires_grad and t.grad_fn is None


def test_evaluate_sharded_matches_single_shard():
    spec = tdatasets.SyntheticSpec("ev", 40, 25, 400, 4)
    stream = tdatasets.generate(spec, seed=1)
    train_s, val_s, _ = stream.chronological_split(0.6, 0.3)
    dst = (spec.n_users, spec.n_users + spec.n_items)
    out = {}
    for n in (1, 4):
        cfg = tmdgnn.MDGNNConfig(variant="tgn", n_nodes=stream.num_nodes,
                                 d_edge=4, d_mem=8, d_msg=8, d_time=4,
                                 d_embed=8, n_neighbors=4, use_pres=True,
                                 use_kernels=True, n_shards=n)
        params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        state = tmdgnn.init_state(cfg, "cpu")
        if n > 1:
            state = trouting.shard_state(cfg, state,
                                         trouting.get_mesh(n, "cpu"))
        opt = toptim.adamw(1e-3)
        gen = torch.Generator().manual_seed(5)
        tb = train_s.temporal_batches(60, "cpu")
        vb = val_s.temporal_batches(60, "cpu")
        params, _, state, res = tloop.run_epoch(
            params, opt.init(params), state, tb, cfg,
            tloop.make_train_step(cfg, opt), gen, dst)
        before = [t.clone() for t in (state["memory"].mem if n > 1
                                      else [state["memory"].mem])]
        ev_state, ap, auc = tloop.evaluate(params, state, vb, cfg,
                                           tloop.make_eval_step(cfg), gen,
                                           dst)
        after = state["memory"].mem if n > 1 else [state["memory"].mem]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        if n > 1:
            ev_state = trouting.unshard_state(cfg, ev_state)
        out[n] = (res.ap, ap, auc, bridge.state_to_numpy(ev_state))
    (tap1, ap1, auc1, s1), (tap4, ap4, auc4, s4) = out[1], out[4]
    assert abs(tap1 - tap4) <= ATOL and abs(ap1 - ap4) <= ATOL
    assert abs(auc1 - auc4) <= ATOL
    for comp in s1:
        for k in s1[comp]:
            np.testing.assert_allclose(s4[comp][k], s1[comp][k], atol=ATOL)


def test_cli_sharded_checkpoint_serves(tmp_path, capsys):
    """--n-shards 4 on the CPU: the same history and checkpoint as the
    unsharded run, which the (unsharded) serve CLI restores; a tight
    --shard-budget reports its overflow by shard in the run-log."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tcli
    model = ["--dataset", "mooc-small", "--model", "tgn", "--pres",
             "--use-kernels", "--device", "cpu", "--d-mem", "8"]
    run = model + ["--batch-size", "2000", "--epochs", "1"]
    paths = {n: str(tmp_path / f"s{n}.ckpt") for n in (1, 4)}
    hist = {n: tcli.main(run + ["--n-shards", str(n), "--checkpoint",
                                paths[n]]) for n in (1, 4)}
    out = capsys.readouterr().out
    assert "[dist] memory-parallel over 4 shards (1 device(s): cpu" in out
    for k in ("loss", "train_ap", "val_ap"):
        assert abs(hist[4][0][k] - hist[1][0][k]) <= ATOL, k
    stream = tdatasets.get_dataset("mooc-small", 0)
    cfg = tmdgnn.MDGNNConfig(variant="tgn", n_nodes=stream.num_nodes,
                             d_edge=stream.feat_dim, d_mem=8, d_msg=8,
                             d_embed=8, use_pres=True, use_kernels=True)
    like = bridge.mdgnn_bundle(tmdgnn.init_params(cfg, device="cpu"),
                               tmdgnn.init_state(cfg, "cpu"))
    a, b = (tio.read_checkpoint(paths[n], like) for n in (1, 4))
    for x, y in zip(tio._flatten(a)[0], tio._flatten(b)[0]):
        np.testing.assert_allclose(y, x, atol=ATOL)
    rep = tserve.main(model + ["--max-events", "200", "--checkpoint",
                               paths[4]])
    assert rep.n_events == 200
    log = tmp_path / "run.jsonl"
    tcli.main(run + ["--n-shards", "4", "--shard-budget", "64",
                     "--metrics-out", str(log)])
    epoch = [json.loads(line) for line in log.read_text().splitlines()
             if '"epoch"' in line and '"kind": "epoch"' in line][0]
    assert len(epoch["route_overflow_shards"]) == 4
    assert epoch["route_overflow"] == sum(epoch["route_overflow_shards"]) > 0


# ---------------------------------------------------------------------------
# bf16 memory tables
# ---------------------------------------------------------------------------


def test_bf16_memory_table_trains():
    """JAX's tests/test_distributed.py::test_bf16_memory_table_trains."""
    spec = tdatasets.SyntheticSpec("b16", 30, 20, 400, 4)
    stream = tdatasets.generate(spec, seed=0)
    cfg = tmdgnn.MDGNNConfig(variant="tgn", n_nodes=stream.num_nodes,
                             d_edge=4, d_mem=8, d_msg=8, d_time=4,
                             d_embed=8, use_pres=True, use_kernels=True,
                             mem_dtype="bfloat16")
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = tmdgnn.init_state(cfg, "cpu")
    assert state["memory"].mem.dtype == torch.bfloat16
    assert state["memory"].last_update.dtype == torch.float32
    opt = toptim.adamw(1e-3)
    _, _, st, res = tloop.run_epoch(
        params, opt.init(params), state,
        stream.temporal_batches(100, "cpu"), cfg,
        tloop.make_train_step(cfg, opt), torch.Generator().manual_seed(1),
        (30, 50))
    assert np.isfinite(res.loss)
    assert st["memory"].mem.dtype == torch.bfloat16
    assert float(st["memory"].mem.float().abs().max()) > 0


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (the spacing of bf16 values there)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.asarray(jb.src), np.asarray(jb.dst), np.asarray(jb.t),
        np.asarray(jb.feat), np.asarray(jb.mask), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jloop.make_train_step(jcfg, joptim.adamw(1e-3))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32), np.float64)
    return out


def _jax_run(jcfg, stream, steps):
    """JAX's run of `steps` train steps from its init: per step (AdamW's
    first moments, memory table, last_update, loss), numpy."""
    jp, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    js = jmdgnn.init_state(jcfg)
    jopt = joptim.adamw(1e-3)
    jos, step = jopt.init(jp), _jax_step(jcfg)
    jb = stream.temporal_batches(100)
    out = []
    for i in range(1, steps + 1):
        neg = jsample(jax.random.PRNGKey(i), jb[i], 50, 80)
        jp, jos, js, jm = step(jp, jos, js, jb[i - 1], jb[i], neg)
        out.append((_flat(jax.tree.map(np.asarray, jos["mu"])),
                    np.asarray(js["memory"].mem).astype(np.float64),
                    np.asarray(js["memory"].last_update),
                    float(jm["loss"])))
    return out


@pytest.mark.parametrize("use_pres", [True, False], ids=["pres", "std"])
def test_bf16_train_steps_match_jax(tiny_stream, use_pres):
    """1 and 3 AdamW steps of a bf16 table against JAX's bf16 run.

    After one step: the table rows within one bf16 ulp plus 1e-5,
    last_update exact, the loss within 1e-5 relative, and the gradients
    (AdamW's first moments, 0.1 g) within 1e-5 of the largest moment of
    any leaf plus twice the spread of JAX's own bf16 run from its fp32
    run (the noise floor): the gradient through a bf16 table reaches the
    parameters through bf16 cotangents, which JAX rounds in more places
    than the port (its bf16 gradients of the memory path are up to 10x
    farther from its fp32 ones than the port's are). The parameters are
    not compared: AdamW's first update, lr * g / |g|, turns that noise on
    a near-zero gradient into a 2 lr step at a random entry. After three
    steps: last_update exact, the table within one ulp plus 1e-4 plus
    twice JAX's own bf16 spread of the table, the loss within 1e-4
    relative plus twice JAX's spread of the loss."""
    kw = dict(variant="tgn", n_nodes=tiny_stream.num_nodes,
              d_edge=tiny_stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
              d_embed=16, n_neighbors=4, use_pres=use_pres, use_kernels=True)
    jcfg = jmdgnn.MDGNNConfig(**kw, mem_dtype="bfloat16")
    want = _jax_run(jcfg, tiny_stream, 3)
    floor = _jax_run(jmdgnn.MDGNNConfig(**kw), tiny_stream, 3)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    jp, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    js = jmdgnn.init_state(jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = bridge.state_from_numpy(
        {"memory": {"mem": np.asarray(js["memory"].mem),
                    "last_update": np.asarray(js["memory"].last_update)},
         "neighbors": {k: np.asarray(v) for k, v in js["neighbors"].items()},
         "pres": {"n": np.asarray(js["pres"].n),
                  "xi": np.asarray(js["pres"].xi),
                  "psi": np.asarray(js["pres"].psi)}}, "cpu")
    assert ts["memory"].mem.dtype == torch.bfloat16
    topt = toptim.adamw(1e-3)
    tos, tstep = topt.init(tp), tloop.make_train_step(tcfg, topt)
    jb = tiny_stream.temporal_batches(100)
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], 50, 80)
        tp, tos, ts, tm = tstep(tp, tos, ts, _tbatch(jb[i - 1]),
                                _tbatch(jb[i]), _tbatch(neg))
        if i == 2:
            continue
        w_mu, w_mem, w_lu, w_loss = want[i - 1]
        f_mu, f_mem, _, f_loss = floor[i - 1]
        assert ts["memory"].mem.dtype == torch.bfloat16
        np.testing.assert_array_equal(ts["memory"].last_update.numpy(),
                                      w_lu)
        err = np.abs(ts["memory"].mem.float().numpy() - w_mem)
        if i == 1:
            # rows written from the same fp32 values
            assert (err <= _bf16_ulp(w_mem) + 1e-5).all()
            assert abs(float(tm["loss"]) - w_loss) <= 1e-5 * abs(w_loss)
            got = _flat(tos["mu"])
            scale = max(float(np.abs(w).max()) for w in w_mu.values())
            for name, w in w_mu.items():
                spread = float(np.abs(w - f_mu[name]).max())
                assert float(np.abs(got[name] - w).max()) <= \
                    1e-5 * scale + 2.0 * spread, name
        else:
            lim = (_bf16_ulp(w_mem) + 1e-4
                   + 2.0 * float(np.abs(w_mem - f_mem).max()))
            assert (err <= lim).all(), float((err - lim).max())
            assert abs(float(tm["loss"]) - w_loss) <= \
                1e-4 * abs(w_loss) + 2.0 * abs(w_loss - f_loss)


def _table_inputs(rng, n=40, m=30, d=16, din=24):
    nodes = rng.integers(0, n, m)
    times = np.round(rng.random(m) * 5).astype(np.float32)
    mask = rng.random(m) >= 0.2
    tn, tt, tm = (torch.as_tensor(nodes), torch.as_tensor(times),
                  torch.as_tensor(mask))
    order = tmdgnn.occurrence_order(tn, tt, tm)
    sel = tmdgnn._last_occurrence_flags(tn, tt, tm)
    gidx = torch.where(tm, tn, n + 1)[order].to(torch.int32).numpy()
    widx = torch.where(sel, tn, n)[order].to(torch.int32).numpy()
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return [f(n, d, sc=0.5), f(n), f(m, din), gidx, widx, tt[order].numpy(),
            f(din, 3 * d, sc=din ** -0.5), f(d, 3 * d, sc=d ** -0.5),
            f(3 * d, sc=0.1), f(m, d, sc=0.3),
            np.round(rng.random(m) * 3).astype(np.float32), np.float32(0.37)]


@pytest.mark.parametrize("mode", ["innovation", "transition"])
def test_bf16_table_plain_version_matches_pallas(mode):
    """The table kernel's plain version on a bf16 table against JAX's
    `_memory_update_table_pallas` in interpret mode: the written rows
    within one bf16 ulp, the rest within ATOL, last_t exact, the rows not
    written untouched."""
    args = _table_inputs(np.random.default_rng(11))
    table16 = jnp.asarray(args[0]).astype(jnp.bfloat16)
    jargs = [table16] + [jnp.asarray(a) for a in args[1:]]
    j_tab, j_lt, j_sm, j_fu, j_de = jmu._memory_update_table_pallas(
        *jargs, clip=1.0, delta_mode=mode, interpret=True)
    t_tab = torch.as_tensor(args[0]).to(torch.bfloat16)
    tin = [t_tab] + [torch.as_tensor(a) for a in args[1:]]
    before = t_tab.clone()
    _, t_lt, t_sm, t_fu, t_de = tref.memory_update_table_ref(
        *tin, clip=1.0, delta_mode=mode)
    assert t_tab.dtype == torch.bfloat16
    want = np.asarray(j_tab).astype(np.float32)
    err = np.abs(t_tab.float().numpy().astype(np.float64) - want)
    assert (err <= _bf16_ulp(want)).all()
    written = args[4][args[4] < 40]
    untouched = np.setdiff1d(np.arange(40), written)
    np.testing.assert_array_equal(t_tab[untouched].float().numpy(),
                                  before[untouched].float().numpy())
    np.testing.assert_array_equal(t_lt.numpy(), np.asarray(j_lt))
    for got, want in ((t_sm, j_sm), (t_fu, j_fu), (t_de, j_de)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_dense_memory_update_matches_pallas():
    """The dense op on bf16 rows h (widened on load) against JAX's
    `_memory_update_pallas` in interpret mode."""
    args = _table_inputs(np.random.default_rng(12))
    x, w, u, b, dmean, scale, gamma = (args[2], args[6], args[7], args[8],
                                       args[9], args[10], args[11])
    h = np.random.default_rng(13).normal(size=(30, 16)).astype(np.float32)
    h16 = jnp.asarray(h).astype(jnp.bfloat16)
    want = jmu._memory_update_pallas(
        jnp.asarray(x), h16, jnp.asarray(w), jnp.asarray(u), jnp.asarray(b),
        jnp.asarray(dmean), jnp.asarray(scale), jnp.asarray(gamma), clip=1.0,
        interpret=True)
    got = tref.memory_update_ref(
        torch.as_tensor(x), torch.as_tensor(h).to(torch.bfloat16),
        *(torch.as_tensor(a) for a in (w, u, b, dmean, scale, gamma)),
        clip=1.0)
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=ATOL)


def test_bf16_checkpoint_leaves_in_jax_format(tmp_path):
    """A bf16 leaf is written as JAX writes one (raw 2-byte values, `|V2`);
    a JAX-written one loads as bf16, and an fp32 leaf into a bf16
    template rounds to nearest even."""
    vals = np.array([1.5, -2.25, 3.0, 1.0 + 2.0 ** -9], np.float32)
    tio.save_checkpoint(str(tmp_path / "t"),
                        {"w": torch.as_tensor(vals).to(torch.bfloat16),
                         "v": torch.ones(2)})
    jio.save_checkpoint(str(tmp_path / "j"),
                        {"w": jnp.asarray(vals, jnp.bfloat16),
                         "v": jnp.ones(2)})
    like = {"w": torch.zeros(4, dtype=torch.bfloat16), "v": torch.zeros(2)}
    for name in ("t", "j"):
        raw = tio.read_checkpoint(str(tmp_path / name), like)
        assert raw["w"].dtype == np.dtype("V2")
        got = tio.load_checkpoint(str(tmp_path / name), like, "cpu")
        assert got["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got["w"].float().numpy(),
            np.asarray(jnp.asarray(vals, jnp.bfloat16)).astype(np.float32))
    leaf = lambda p: tio.read_checkpoint(str(p), like)["w"].tobytes()
    assert leaf(tmp_path / "t") == leaf(tmp_path / "j")
    # an fp32 file into a bf16 template
    tio.save_checkpoint(str(tmp_path / "f"), {"w": torch.as_tensor(vals),
                                             "v": torch.ones(2)})
    got = tio.load_checkpoint(str(tmp_path / "f"), like, "cpu")
    assert torch.equal(got["w"], torch.as_tensor(vals).to(torch.bfloat16))
    # and a bf16 file into an fp32 template widens exactly
    got = tio.load_checkpoint(str(tmp_path / "t"),
                              {"w": torch.zeros(4), "v": torch.zeros(2)},
                              "cpu")
    assert torch.equal(got["w"], torch.as_tensor(vals).to(torch.bfloat16)
                       .float())
