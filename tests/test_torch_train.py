"""The port's training slice against the JAX package on the CPU.

Both sides start from the same parameters (JAX's init, moved through
`repro_torch.bridge`), fold the same temporal batches and score the same
negatives (JAX's draws, injected into the port: `jax.random` bits cannot be
reproduced). The JAX step runs with use_kernels=True, which on the CPU
resolves every kernel to its jitted jnp oracle; the port's to its plain
PyTorch version through the same autograd Functions the card runs.

Tolerances: AdamW 1e-7 (same formula, fp32); coherence 1e-6; loss 1e-5
relative, logits 1e-4; memory table and parameters 1e-5 after one step and
1e-4 after three (the JAX package pins the same between its own routes,
tests/test_kernel_path.py); last_update and rings exact; trackers 1e-4
(sums in another order); epoch and validation AP 1e-3."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.core import coherence as jcoherence
from repro.graph.negatives import sample_negatives as jsample
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.train import loop as jloop

from repro_torch import bridge
from repro_torch.core import coherence as tcoherence
from repro_torch.graph import events as tevents
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import loop as tloop

B = 100            # temporal batch size on the 600-event tiny stream


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jstate_np(state):
    return {"memory": {"mem": np.array(state["memory"].mem),
                       "last_update": np.array(state["memory"].last_update)},
            "neighbors": {k: np.array(v)
                          for k, v in state["neighbors"].items()},
            "pres": {"n": np.array(state["pres"].n),
                     "xi": np.array(state["pres"].xi),
                     "psi": np.array(state["pres"].psi)}}


def _tstream(s):
    return tevents.EventStream(s.src, s.dst, s.t, s.feat, s.num_nodes)


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """The jitted JAX train step of `jcfg`, compiled once for every test
    that trains that configuration."""
    return jloop.make_train_step(jcfg, joptim.adamw(1e-3))


def _setup(stream, use_pres, n_layers, seed=0):
    """Same config, params, state and optimizer on both sides."""
    jcfg = jmdgnn.MDGNNConfig(
        variant="tgn", n_nodes=stream.num_nodes, d_edge=stream.feat_dim,
        d_mem=16, d_msg=16, d_time=8, d_embed=16, n_neighbors=4,
        n_layers=n_layers, use_pres=use_pres, use_kernels=True)
    tcfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    jstate = jmdgnn.init_state(jcfg)
    tparams = bridge.params_from_numpy(_np_tree(jparams), "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    return (jcfg, jparams, jopt, jopt.init(jparams), jstate,
            tcfg, tparams, topt, topt.init(tparams), tstate)


def _close(got, want, tol, what, floor=1.0):
    """|got - want| <= tol * max(floor, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
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


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_jax(weight_decay):
    rng = np.random.default_rng(0)
    shapes = {"a": {"w": (5, 7), "b": (7,)}, "c": (), "d": (3,)}
    params = jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    jopt = joptim.adamw(1e-3, weight_decay=weight_decay)
    topt = toptim.adamw(1e-3, weight_decay=weight_decay)
    jp = jax.tree.map(jax.numpy.asarray, params)
    tp = bridge.params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 10.0 ** -step)
            .astype(np.float32), params)
        ju, js = jopt.update(jax.tree.map(jax.numpy.asarray, grads), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(bridge.params_from_numpy(grads, "cpu"), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        _assert_params(tp, jax.tree.map(np.asarray, jp), 1e-7)
        _assert_params(ts["nu"], jax.tree.map(np.asarray, js["nu"]), 1e-7)
        assert int(ts["step"]) == int(js["step"]) == step + 1


def test_temporal_batches_match_jax(tiny_stream):
    ts = _tstream(tiny_stream)
    for jpart, tpart in zip(tiny_stream.chronological_split(),
                            ts.chronological_split()):
        assert len(jpart) == len(tpart)
        jb = jpart.temporal_batches(64)
        tb = tpart.temporal_batches(64, "cpu")
        assert len(jb) == len(tb) == tpart.num_batches(64)
        for a, b in zip(jb, tb):
            for col in ("src", "dst", "t", "feat", "mask"):
                x = np.asarray(getattr(a, col))
                y = getattr(b, col).numpy()
                assert x.shape == y.shape, col
                np.testing.assert_array_equal(y, x)
            # node ids are widened to int64 indices, the rest keeps its type
            assert b.t.dtype == torch.float32 and b.mask.dtype == torch.bool
    assert not tb[-1].mask.all()            # the last batch is padded


def test_coherence_penalty_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    b = (a + 0.3 * rng.normal(size=(40, 16))).astype(np.float32)
    mask = rng.random(40) < 0.7
    for m in (None, mask):
        want = jcoherence.coherence_penalty(a, b, mask=m)
        got = tcoherence.coherence_penalty(
            torch.as_tensor(a), torch.as_tensor(b),
            mask=None if m is None else torch.as_tensor(m))
        assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("use_pres", [True, False], ids=["pres", "std"])
def test_train_steps_match_jax(tiny_stream, tiny_spec, use_pres, n_layers):
    """One step at 1e-5 and three at 1e-4, Alg. 2 (PRES) and Alg. 1."""
    (jcfg, jparams, jopt, jos, jstate,
     tcfg, tparams, topt, tos, tstate) = _setup(tiny_stream, use_pres,
                                                n_layers)
    jstep = _jax_step(jcfg)
    tstep = tloop.make_train_step(tcfg, topt)
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], *dst)
        jparams, jos, jstate, jm = jstep(jparams, jos, jstate, jb[i - 1],
                                         jb[i], neg)
        tparams, tos, tstate, tm = tstep(tparams, tos, tstate,
                                         _tbatch(jb[i - 1]), _tbatch(jb[i]),
                                         _tbatch(neg))
        tol = 1e-5 if i == 1 else 1e-4
        want_loss = float(jm["loss"])
        assert abs(float(tm["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
        for k in ("logit_p", "logit_n"):
            _close(tm[k].numpy(), jm[k], 1e-4, k)
        _assert_state(tstate, jstate, tol)
        _assert_params(tparams, jax.tree.map(np.asarray, jparams), tol)
        # the first moments are the gradients' running mean (after step one
        # exactly 0.1 * grad): each leaf relative to its own largest entry
        _assert_params(tos["mu"], jax.tree.map(np.asarray, jos["mu"]), tol,
                       floor=0.0)
        assert not any(p.grad_fn is not None for p in
                       (tstate["memory"].mem, tstate["memory"].last_update))


def test_epoch_and_evaluate_match_jax(tiny_stream, tiny_spec):
    """One epoch of Alg. 2 and the evaluation after it, the JAX package's
    run_epoch / evaluate against the port's with the same negatives."""
    (jcfg, jparams, jopt, jos, jstate,
     tcfg, tparams, topt, tos, tstate) = _setup(tiny_stream, True, 1)
    # 360 training events (4 batches, the last padded) and 180 validation
    # events (2 batches, the last padded), at the step tests' batch size so
    # that the JAX step compiled there is reused
    train_s, val_s, _ = tiny_stream.chronological_split(0.6, 0.3)
    dst = _dst(tiny_spec)

    def jax_negatives(key, batches):
        # the draws run_epoch / evaluate make from `key`, in order
        out = []
        for b in batches[1:]:
            key, sub = jax.random.split(key)
            out.append(_tbatch(jsample(sub, b, *dst)))
        return out

    jtb, jvb = train_s.temporal_batches(B), val_s.temporal_batches(B)
    k_train, k_val = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    jparams, jos, jstate, jres = jloop.run_epoch(
        jparams, jos, jstate, jtb, jcfg, _jax_step(jcfg), k_train, dst)
    _, jvap, jvauc = jloop.evaluate(jparams, jstate, jvb, jcfg,
                                    jloop.make_eval_step(jcfg), k_val, dst)

    ttb = _tstream(train_s).temporal_batches(B, "cpu")
    tvb = _tstream(val_s).temporal_batches(B, "cpu")
    tparams, tos, tstate, tres = tloop.run_epoch(
        tparams, tos, tstate, ttb, tcfg, tloop.make_train_step(tcfg, topt),
        None, dst, negatives=jax_negatives(k_train, jtb))
    before = bridge.state_to_numpy(tstate)
    _, tvap, tvauc = tloop.evaluate(
        tparams, tstate, tvb, tcfg, tloop.make_eval_step(tcfg), None, dst,
        negatives=jax_negatives(k_val, jvb))
    after = bridge.state_to_numpy(tstate)
    for part in before:                      # evaluate left the state alone
        for k in before[part]:
            np.testing.assert_array_equal(before[part][k], after[part][k])
    assert abs(tres.ap - jres.ap) <= 1e-3
    assert abs(tres.loss - jres.loss) <= 1e-4 * abs(jres.loss)
    assert abs(tvap - jvap) <= 1e-3 and abs(tvauc - jvauc) <= 1e-3
    _assert_state(tstate, jstate, 1e-4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_launch_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as ttrain
    out = tmp_path / "run.json"
    hist = ttrain.main(["--dataset", "mooc-small", "--model", "tgn",
                        "--pres", "--use-kernels", "--device", "cpu",
                        "--d-mem", "8", "--batch-size", "2000", "--epochs",
                        "1", "--json-out", str(out)])
    printed = capsys.readouterr().out
    assert "epoch 0: loss=" in printed and "val_ap=" in printed
    assert len(hist) == 1 and 0.0 <= hist[0]["val_ap"] <= 1.0
    assert out.exists()
    # macro-batches (ported by the fourteenth slice) train, and so does
    # memory parallelism (the fifteenth)
    hist = ttrain.main(["--dataset", "mooc-small", "--pres", "--use-kernels",
                        "--device", "cpu", "--d-mem", "8", "--batch-size",
                        "2000", "--epochs", "1", "--scan-chunk", "2"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert "scan_chunk=2" in capsys.readouterr().out
    hist = ttrain.main(["--dataset", "mooc-small", "--use-kernels",
                        "--device", "cpu", "--d-mem", "8", "--batch-size",
                        "2000", "--epochs", "1", "--n-shards", "2"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert "[dist] memory-parallel over 2 shards" in capsys.readouterr().out
    # no --use-kernels: the plain route, as the JAX CLI runs; and JODIE
    small = ["--device", "cpu", "--d-mem", "8", "--batch-size", "2000",
             "--epochs", "1"]
    for flags in ([], ["--use-kernels", "--model", "jodie"]):
        hist = ttrain.main(small + flags)
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--pres", "--use-kernels"])


@pytest.mark.parametrize("flags", [
    ["--pres", "--pipeline-depth", "2"], ["--pres", "--model", "apan"],
    ["--model", "apan"], ["--no-dedup-embed"]],
    ids=["pipeline", "apan-pres", "apan-std", "dense"])
def test_launch_train_cli_paths_on_cpu(flags, capsys):
    """One epoch of each path the third slice added, through the CLI."""
    from repro_torch.launch import train as ttrain
    hist = ttrain.main(["--dataset", "wiki-small", "--use-kernels",
                        "--device", "cpu", "--d-mem", "8", "--batch-size",
                        "2000", "--epochs", "1", *flags])
    printed = capsys.readouterr().out
    assert "epoch 0: loss=" in printed
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert 0.0 <= hist[0]["val_ap"] <= 1.0
    if "--pipeline-depth" in flags:
        assert "pipeline_depth=2" in printed
