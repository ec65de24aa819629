"""The MDGNN options the tenth slice of the port accepts, against the JAX
package on the CPU: JODIE (its embedding, train steps of Alg. 1 and
Alg. 2, an epoch and `evaluate`, serving, both CLIs), the plain route
(`use_kernels=False`: the reference's composition of the plain cell,
`pres.predict` / `pres.correct` and the plain attention, for dedup and
dense TGN, APAN, JODIE, the pipelined step and serving), hashed PRES
trackers (`pres_buckets`) and `anchor_fraction`, which neither engine
reads.

Both sides start from JAX's parameters and state, moved through
`repro_torch.bridge`, and score the same negatives (JAX's draws,
injected). The JAX kernel route runs on the CPU through its jitted jnp
oracles; the port's through the plain versions behind the autograd
Functions the card runs.

Tolerances (those of tests/test_torch_train.py): loss 1e-5 relative;
logits 1e-4; memory table and parameters 1e-5 of their scale after one
step and 1e-4 after three, the first moments the same of the largest
moment of any leaf; last_update, rings, mailbox
times and tracker counts exact; tracker sums 1e-4 (sums in another
order); embeddings 1e-5; epoch and validation AP 1e-3; serving state
1e-5 after one ingest, 1e-4 after several, scores 1e-4."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.graph.negatives import sample_negatives as jsample
from repro.models import embeddings as jemb
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.serve import MicroBatcher as JBatcher
from repro.serve import ServeEngine as JEngine
from repro.train import loop as jloop
from repro.train import pipeline as jpipeline

from repro_torch import bridge
from repro_torch.graph import events as tevents
from repro_torch.kernels import ops
from repro_torch.models import embeddings as temb
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.serve import MicroBatcher, ServeEngine
from repro_torch.train import loop as tloop
from repro_torch.train import pipeline as tpipeline

B = 100            # temporal batch size on the 600-event tiny stream


def _close(got, want, tol, what, floor=1.0):
    """|got - want| <= tol * max(floor, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol * max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _assert_tree(tp, jp, tol, path="", floor=1.0):
    if isinstance(jp, dict):
        for k in jp:
            _assert_tree(tp[k], jp[k], tol, f"{path}/{k}", floor)
    else:
        _close(tp.detach().numpy(), np.asarray(jp), tol, path, floor)


def _jstate_np(state):
    out = {"memory": {"mem": np.array(state["memory"].mem),
                      "last_update": np.array(state["memory"].last_update)},
           "neighbors": {k: np.array(v)
                         for k, v in state["neighbors"].items()},
           "pres": {"n": np.array(state["pres"].n),
                    "xi": np.array(state["pres"].xi),
                    "psi": np.array(state["pres"].psi)}}
    if "mailbox" in state:
        out["mailbox"] = {k: np.array(v) for k, v in state["mailbox"].items()}
    return out


def _assert_state(ts, js, tol):
    """Rings, mailbox, times and counts exact; table and trackers at tol."""
    a, b = bridge.state_to_numpy(ts), _jstate_np(js)
    assert a.keys() == b.keys()
    for part in ("neighbors", "mailbox"):
        for k in b.get(part, {}):
            if k == "msg":
                _close(a[part][k], b[part][k], tol, "mailbox messages")
            else:
                np.testing.assert_array_equal(a[part][k], b[part][k])
    np.testing.assert_array_equal(a["memory"]["last_update"],
                                  b["memory"]["last_update"])
    assert a["pres"]["n"].shape == b["pres"]["n"].shape
    np.testing.assert_array_equal(a["pres"]["n"], b["pres"]["n"])
    _close(a["memory"]["mem"], b["memory"]["mem"], tol, "memory table")
    for k in ("xi", "psi"):
        _close(a["pres"][k], b["pres"][k], 1e-4, f"tracker {k}")


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


def _jcfg(stream, variant="tgn", **kw):
    base = dict(variant=variant, n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
                d_embed=16, n_neighbors=4, mailbox_size=3, use_pres=True,
                use_kernels=True)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _tcfg(jcfg):
    return tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """The jitted JAX train step of `jcfg` (pipelined at depth >= 1),
    compiled once for every test that trains that configuration."""
    return jpipeline.make_train_step(jcfg, joptim.adamw(1e-3))


def _setup(jcfg, seed=0):
    """JAX's params, state and optimizer state, and the port's copies."""
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    jstate = jmdgnn.init_state(jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    return (jparams, jopt.init(jparams), jstate,
            tparams, topt, topt.init(tparams), tstate)


# ---------------------------------------------------------------------------
# the configuration check and JODIE's embedding
# ---------------------------------------------------------------------------


def test_param_shapes_match_jax_jodie(tiny_stream):
    for n_layers in (1, 3):
        jcfg = _jcfg(tiny_stream, "jodie", n_layers=n_layers)
        jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
        want = jax.tree.map(lambda a: tuple(a.shape), jparams)
        assert tmdgnn.param_shapes(_tcfg(jcfg)) == want


@pytest.mark.parametrize("n_layers", [1, 2])
def test_jodie_apply_matches_jax(tiny_stream, n_layers):
    """JODIE's embedding of random memory rows and times, and its
    gradient with respect to the memory table (through index_select)."""
    jcfg = _jcfg(tiny_stream, "jodie", n_layers=n_layers)
    n = jcfg.n_nodes
    rng = np.random.default_rng(3)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(1), jcfg)
    mem = rng.normal(size=(n, jcfg.d_mem)).astype(np.float32)
    last = rng.uniform(0, 50, n).astype(np.float32)
    nodes = rng.integers(0, n, 40).astype(np.int32)
    tq = rng.uniform(50, 90, 40).astype(np.float32)

    def jfn(m):
        state = {"memory": jmdgnn.MemoryState(mem=m, last_update=last)}
        return jemb.jodie_apply(jparams, jcfg, state, nodes, tq)
    want, vjp = jax.vjp(jfn, jax.numpy.asarray(mem))
    cot = rng.normal(size=want.shape).astype(np.float32)
    (want_g,) = vjp(cot)

    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    tm = torch.tensor(mem, requires_grad=True)
    state = {"memory": tmdgnn.MemoryState(mem=tm,
                                          last_update=torch.tensor(last))}
    got = tmdgnn.embed_nodes(tparams, _tcfg(jcfg), state,
                             torch.tensor(nodes, dtype=torch.int64),
                             torch.tensor(tq))
    _close(got.detach().numpy(), want, 1e-5, "jodie embedding")
    got.backward(torch.tensor(cot))
    _close(tm.grad.numpy(), want_g, 1e-5, "gradient of the memory rows",
           floor=0.0)
    assert temb.VARIANT_EMBEDDINGS["jodie"] is temb.jodie_apply


# ---------------------------------------------------------------------------
# train steps: JODIE, the plain route, hashed trackers, anchor fraction
# ---------------------------------------------------------------------------

# id -> MDGNNConfig changes from _jcfg's (TGN, PRES, kernels)
STEP_CASES = {
    "jodie-pres": dict(variant="jodie"),
    "jodie-std": dict(variant="jodie", use_pres=False),
    "plain-dedup-l2": dict(use_kernels=False, n_layers=2),
    "plain-dense": dict(use_kernels=False, dedup_embed=False),
    "plain-apan": dict(variant="apan", use_kernels=False),
    "plain-std": dict(use_kernels=False, use_pres=False),
    "plain-pipe-d2": dict(use_kernels=False, pipeline_depth=2),
    "buckets-8": dict(pres_buckets=8),
    "buckets-quarter": dict(pres_buckets=-4),
}


def _step_cfg(stream, case):
    kw = dict(STEP_CASES[case])
    if kw.get("pres_buckets") == -4:
        kw["pres_buckets"] = stream.num_nodes // 4
    return _jcfg(stream, **kw)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(tiny_stream, tiny_spec, case):
    """One step at 1e-5 and three at 1e-4; no kernel launched on the
    plain route; trackers of pres_buckets rows."""
    jcfg = _step_cfg(tiny_stream, case)
    tcfg = _tcfg(jcfg)
    jparams, jos, jstate, tparams, topt, tos, tstate = _setup(jcfg)
    rows = jcfg.pres_buckets or jcfg.n_nodes
    assert tstate["pres"].n.shape == (rows + 1, 2)
    jstep = _jax_step(jcfg)
    tstep = tpipeline.make_train_step(tcfg, topt)
    depth = jcfg.pipeline_depth
    if depth:
        jps = jpipeline.PipelineState.init(jstate["memory"])
        tps = tpipeline.PipelineState.init(tstate["memory"])
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], *dst)
        jargs = (jb[i - 1], jb[i], neg)
        targs = (_tbatch(jb[i - 1]), _tbatch(jb[i]), _tbatch(neg))
        if depth:
            jparams, jos, jstate, jps, jm = jstep(jparams, jos, jstate, jps,
                                                  *jargs)
            tparams, tos, tstate, tps, tm = tstep(tparams, tos, tstate, tps,
                                                  *targs)
            _close(tps.read_mem.numpy(), np.asarray(jps.read_mem),
                   1e-5 if i == 1 else 1e-4, "snapshot")
        else:
            jparams, jos, jstate, jm = jstep(jparams, jos, jstate, *jargs)
            tparams, tos, tstate, tm = tstep(tparams, tos, tstate, *targs)
        tol = 1e-5 if i == 1 else 1e-4
        want_loss = float(jm["loss"])
        assert abs(float(tm["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
        for k in ("logit_p", "logit_n"):
            _close(tm[k].numpy(), jm[k], 1e-4, k)
        _assert_state(tstate, jstate, tol)
        _assert_tree(tparams, jparams, tol)
        # the first moments (after step one 0.1 x the gradient) as one
        # vector: a leaf whose gradient is a sum that nearly cancels (JODIE's
        # gamma_logit) keeps the absolute rounding of its terms
        top = max(float(np.abs(np.asarray(m)).max())
                  for m in jax.tree.leaves(jos["mu"]))
        _assert_tree(tos["mu"], jos["mu"], tol, floor=top)
    assert tstate["pres"].n.shape == (rows + 1, 2)
    if jcfg.use_pres:
        assert float(tstate["pres"].n.sum()) > 0


def test_anchor_fraction_is_not_read(tiny_stream, tiny_spec):
    """anchor_fraction=0.5 gives the step of 1.0 in both packages: the
    field is accepted and read by neither engine (ROADMAP R6)."""
    dst = _dst(tiny_spec)
    jb = tiny_stream.temporal_batches(B)
    neg = jsample(jax.random.PRNGKey(1), jb[1], *dst)
    out = {}
    for frac in (1.0, 0.5):
        jcfg = _jcfg(tiny_stream, anchor_fraction=frac)
        tmdgnn.check_supported(_tcfg(jcfg))
        jparams, jos, jstate, tparams, topt, tos, tstate = _setup(jcfg)
        jm = _jax_step(jcfg)(
            jparams, jos, jstate, jb[0], jb[1], neg)[-1]
        tm = tloop.make_train_step(_tcfg(jcfg), topt)(
            tparams, tos, tstate, _tbatch(jb[0]), _tbatch(jb[1]),
            _tbatch(neg))[-1]
        out[frac] = (float(jm["loss"]), float(tm["loss"]),
                     tm["logit_p"].numpy())
    assert out[0.5][0] == out[1.0][0] and out[0.5][1] == out[1.0][1]
    np.testing.assert_array_equal(out[0.5][2], out[1.0][2])
    assert abs(out[1.0][1] - out[1.0][0]) <= 1e-5 * abs(out[1.0][0])


def test_plain_route_launches_no_kernel(tiny_stream, tiny_spec,
                                        monkeypatch):
    """use_kernels=False calls no registry op, where the kernel route of
    the same configuration calls its memory and embedding kernels."""
    called = []
    for name, spec in list(ops.REGISTRY.items()):
        def ref(*a, _name=name, _ref=spec.ref, **kw):
            called.append(_name)
            return _ref(*a, **kw)
        monkeypatch.setitem(ops.REGISTRY, name,
                            dataclasses.replace(spec, ref=ref))
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    for kernels in (False, True):
        del called[:]
        tcfg = _tcfg(_jcfg(tiny_stream, use_kernels=kernels,
                           pipeline_depth=2))
        params = tmdgnn.init_params(tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt = toptim.adamw(1e-3)
        state = tmdgnn.init_state(tcfg, "cpu")
        ps = tpipeline.PipelineState.init(state["memory"])
        tpipeline.make_train_step(tcfg, opt)(
            params, opt.init(params), state, ps, _tbatch(jb[0]),
            _tbatch(jb[1]), _tbatch(jsample(jax.random.PRNGKey(1), jb[1],
                                            *dst)))
        if kernels:
            assert {"memory_update_table", "embed_attn",
                    "pres_predict"} <= set(called)
        else:
            assert called == []


# ---------------------------------------------------------------------------
# the staleness fill with hashed trackers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("buckets", [8, None], ids=["b8", "per-node"])
def test_stale_read_table_buckets_match_jax(tiny_stream, buckets, kernels):
    jcfg = _jcfg(tiny_stream, pres_buckets=buckets, use_kernels=kernels,
                 pipeline_depth=2)
    n, d = jcfg.n_nodes, jcfg.d_mem
    rows = buckets or n
    rng = np.random.default_rng(5)
    cnt = rng.integers(0, 4, (rows, 2)).astype(np.float32)
    xi = (rng.normal(size=(rows, 2, d)) * cnt[..., None]).astype(np.float32)
    psi = (xi ** 2 + rng.uniform(0, 1, (rows, 2, d))).astype(np.float32)
    tree = {"read_mem": rng.normal(size=(n, d)).astype(np.float32),
            "read_last_update": rng.uniform(0, 9, n).astype(np.float32),
            "pending": rng.integers(0, 3, n).astype(np.float32), "tick": 1}
    jps = jpipeline.PipelineState(
        **{k: jax.numpy.asarray(v) for k, v in tree.items()})
    jpres = jmdgnn.PresState(n=cnt, xi=xi, psi=psi)
    want = jpipeline.stale_read_table(jcfg, jpres, jps, None)
    tpres = bridge.state_from_numpy({
        "memory": {"mem": tree["read_mem"],
                   "last_update": tree["read_last_update"]},
        "neighbors": {"nbr": np.zeros((n, 1), np.int32),
                      "t": np.zeros((n, 1), np.float32),
                      "ptr": np.zeros(n, np.int32)},
        "pres": {"n": cnt, "xi": xi, "psi": psi}}, "cpu")["pres"]
    got = tpipeline.stale_read_table(
        _tcfg(jcfg), tpres, bridge.pipeline_state_from_numpy(tree, "cpu"))
    _close(got.numpy(), want, 1e-6, "staleness fill")


# ---------------------------------------------------------------------------
# an epoch and evaluate (JODIE), and the per-step APs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["jodie-pres", "plain-pipe-d2"])
def test_epoch_and_evaluate_match_jax(tiny_stream, tiny_spec, case):
    """One epoch (with collect_logits: the per-step APs) and the
    evaluation after it, JAX's run_epoch / evaluate against the port's
    with the same negatives."""
    jcfg = _step_cfg(tiny_stream, case)
    tcfg = _tcfg(jcfg)
    jparams, jos, jstate, tparams, topt, tos, tstate = _setup(jcfg)
    train_s, val_s, _ = tiny_stream.chronological_split(0.6, 0.3)
    dst = _dst(tiny_spec)

    def jax_negatives(key, batches):
        out = []
        for b in batches[1:]:
            key, sub = jax.random.split(key)
            out.append(_tbatch(jsample(sub, b, *dst)))
        return out

    jtb, jvb = train_s.temporal_batches(B), val_s.temporal_batches(B)
    k_train, k_val = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    jparams, jos, jstate, jres = jpipeline.run_epoch(
        jparams, jos, jstate, jtb, jcfg, _jax_step(jcfg), k_train, dst,
        collect_logits=True)
    _, jvap, jvauc = jloop.evaluate(jparams, jstate, jvb, jcfg,
                                    jloop.make_eval_step(jcfg), k_val, dst)
    ttb = _tstream(train_s).temporal_batches(B, "cpu")
    tvb = _tstream(val_s).temporal_batches(B, "cpu")
    tparams, tos, tstate, tres = tpipeline.run_epoch(
        tparams, tos, tstate, ttb, tcfg,
        tpipeline.make_train_step(tcfg, topt), None, dst,
        negatives=jax_negatives(k_train, jtb), collect_logits=True)
    _, tvap, tvauc = tloop.evaluate(
        tparams, tstate, tvb, tcfg, tloop.make_eval_step(tcfg), None, dst,
        negatives=jax_negatives(k_val, jvb))
    assert len(tres.aps) == len(jres.aps) == len(jtb) - 1
    np.testing.assert_allclose(tres.aps, jres.aps, atol=1e-3, rtol=0)
    assert abs(tres.ap - jres.ap) <= 1e-3
    assert abs(tres.loss - jres.loss) <= 1e-4 * abs(jres.loss)
    assert abs(tvap - jvap) <= 1e-3 and abs(tvauc - jvauc) <= 1e-3
    _assert_state(tstate, jstate, 1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["jodie", "plain", "plain-buckets"])
def test_serve_matches_jax(tiny_stream, tiny_spec, case):
    """ServeEngine ingest, query and top-k: JODIE through the kernel
    route (memory_update_table, link_score), TGN on the plain route (no
    kernel), TGN with hashed trackers on the plain route."""
    kw = {"jodie": dict(variant="jodie"),
          "plain": dict(use_kernels=False),
          "plain-buckets": dict(use_kernels=False, pres_buckets=8)}[case]
    jcfg = _jcfg(tiny_stream, **kw)
    dst = _dst(tiny_spec)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jmdgnn.init_state(jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    buckets = (16, 64)
    je = JEngine(jcfg, jparams, jstate, item_range=dst,
                 batcher=JBatcher(buckets=buckets, d_edge=jcfg.d_edge))
    te = ServeEngine(_tcfg(jcfg), tparams, tstate, item_range=dst,
                     device="cpu",
                     batcher=MicroBatcher(buckets=buckets,
                                          d_edge=jcfg.d_edge))
    s, d, t, f = (tiny_stream.src, tiny_stream.dst, tiny_stream.t,
                  tiny_stream.feat)
    lo = 0
    for i, n in enumerate((40, 3, 64, 17)):
        je.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        te.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        lo += n
        _assert_state(te.state, je.state, 1e-5 if i == 0 else 1e-4)
    q = slice(lo, lo + 30)
    np.testing.assert_allclose(te.query(s[q], d[q], t[q]),
                               je.query(s[q], d[q], t[q]), atol=1e-4, rtol=0)
    jv, ji = je.recommend_topk(s[lo:lo + 4], t[lo:lo + 4], 5)
    tv, ti = te.recommend_topk(s[lo:lo + 4], t[lo:lo + 4], 5)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-4, rtol=0)
    jv = np.asarray(jv)
    for r, j in zip(*np.nonzero(ti != np.asarray(ji))):
        # ids may differ only between items whose scores tie within 1e-4
        gaps = [abs(jv[r, j] - jv[r, j + o]) for o in (-1, 1)
                if 0 <= j + o < jv.shape[1]]
        assert min(gaps) <= 1e-4, (r, j, jv[r])


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--model", "jodie", "--pres", "--use-kernels"],
    ["--model", "jodie"], ["--pres", "--pipeline-depth", "2"]],
    ids=["jodie-pres", "jodie-plain", "plain-pipe"])
def test_launch_train_cli_jodie_and_plain(flags, capsys):
    """One epoch through the train CLI on the CPU: JODIE on either route,
    and the plain route (no --use-kernels) of the pipelined schedule."""
    from repro_torch.launch import train as ttrain
    hist = ttrain.main(["--dataset", "wiki-small", "--device", "cpu",
                        "--d-mem", "8", "--batch-size", "2000", "--epochs",
                        "1", *flags])
    printed = capsys.readouterr().out
    assert "epoch 0: loss=" in printed
    assert ("[kernels]" in printed) == ("--use-kernels" in flags)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert 0.0 <= hist[0]["val_ap"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--model", "jodie", "--epochs", "1"])
