"""The port's optimizers and schedules (`optim/`) against the JAX
package's (`tests/test_optim.py`'s checks, each also held against JAX).

AdamW, Adafactor and SGD (with and without momentum) descend a convex
quadratic as JAX's tests require, and their iterates follow JAX's on the
same tree (within 1e-5 * max(1, |ref|) after 50 steps: float32 sums in
another order); weight decay shrinks a parameter with a zero gradient;
Adafactor's state is factored over the last two dims of a stacked (L, m,
n) leaf and its clipped update equals JAX's; `clip_by_global_norm`,
`cosine_schedule`, `pres_schedule` and a callable `lr` equal JAX's."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched

from repro_torch import optim
from repro_torch.optim import schedules
from repro_torch.utils.tree import tree_leaves, tree_map

TOL = 1e-5


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _quad(params, lib):
    """JAX's test objective: sum (a - 3)^2 + sum (b.c + 1)^2."""
    return (lib.sum((params["a"] - 3.0) ** 2)
            + lib.sum((params["b"]["c"] + 1.0) ** 2))


def _start():
    return {"a": np.asarray([10.0, -4.0], np.float32),
            "b": {"c": np.asarray([[2.0, 2.0]], np.float32)}}


def _port_run(opt, params, steps):
    params = tree_map(torch.tensor, params)
    state = opt.init(params)
    for _ in range(steps):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(_quad(params, torch), leaves)
        grads = dict(a=grads[0], b={"c": grads[1]})
        updates, state = opt.update(grads, state, params)
        optim.apply_updates(params, updates)
    return tree_map(lambda t: t.detach(), params), state


def _jax_run(opt, params, steps):
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        g = jax.grad(lambda q: _quad(q, jnp))(p)
        u, s = opt.update(g, s, p)
        return jopt.apply_updates(p, u), s

    for _ in range(steps):
        params, state = step(params, state)
    return params, state


CASES = [("adamw", dict(lr=0.05), 400), ("adafactor", dict(lr=0.5), 400),
         ("sgd", dict(lr=0.1), 400),
         ("sgd", dict(lr=0.05, momentum=0.9), 400)]


@pytest.mark.parametrize("name,kw,steps", CASES,
                         ids=["adamw", "adafactor", "sgd", "sgd-momentum"])
def test_optimizer_minimizes_quadratic_as_jax(name, kw, steps):
    params, _ = _port_run(optim.OPTIMIZERS[name](**kw), _start(), steps)
    assert float(_quad(params, torch)) < 1e-2
    got, _ = _port_run(optim.OPTIMIZERS[name](**kw), _start(), 50)
    want, _ = _jax_run(jopt.OPTIMIZERS[name](**kw), _start(), 50)
    _close(got["a"], want["a"], f"{name} a")
    _close(got["b"]["c"], want["b"]["c"], f"{name} b.c")


def test_adamw_weight_decay_matches_jax():
    opt, jo = optim.adamw(0.1, weight_decay=0.5), jopt.adamw(
        0.1, weight_decay=0.5)
    p, jp = {"w": torch.tensor([5.0])}, {"w": jnp.asarray([5.0])}
    s, js = opt.init(p), jo.init(jp)
    for _ in range(20):
        u, s = opt.update({"w": torch.tensor([0.0])}, s, p)
        optim.apply_updates(p, u)
        ju, js = jo.update({"w": jnp.asarray([0.0])}, js, jp)
        jp = jopt.apply_updates(jp, ju)
    assert float(p["w"][0]) < 5.0
    _close(p["w"], jp["w"], "decayed w")


def test_adafactor_factored_state_on_stacked_leaves():
    """A stacked (L, m, n) leaf keeps (L, m) row and (L, n) column
    statistics, a vector a full one, as JAX's; the update (factored, then
    clipped to RMS <= 1 over the whole leaf) equals JAX's over 3 steps."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 8, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    opt, jo = optim.adafactor(0.01), jopt.adafactor(0.01)
    p = tree_map(torch.tensor, params)
    state = opt.init(p)
    shapes = {k: tuple(v.shape) for k, v in state["m"]["w"].items()}
    assert shapes == {"vr": (3, 8), "vc": (3, 5)}
    assert tuple(state["m"]["b"]["v"].shape) == (5,)
    n_state = sum(v.numel() for v in tree_leaves(state["m"]))
    assert n_state < 3 * 8 * 5 + 5
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    for i in range(3):
        g = {"w": (rng.normal(size=(3, 8, 5)) * (i + 1)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
        u, state = opt.update(tree_map(torch.tensor, g), state, p)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        for k in ("w", "b"):
            _close(u[k], ju[k], f"update {k} step {i}")
        optim.apply_updates(p, u)
        jp = jopt.apply_updates(jp, ju)
    _close(state["m"]["w"]["vr"], js["m"]["w"]["vr"], "vr")
    _close(state["m"]["w"]["vc"], js["m"]["w"]["vc"], "vc")
    assert int(state["step"]) == int(js["step"]) == 3


def test_clip_by_global_norm_matches_jax():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 5.0, rtol=1e-6)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-6)
    same, _ = optim.clip_by_global_norm(g, 10.0)
    np.testing.assert_array_equal(same["a"].numpy(), [3.0, 4.0])
    rng = np.random.default_rng(1)
    tree = {"x": rng.normal(size=(4, 3)).astype(np.float32),
            "y": {"z": rng.normal(size=7).astype(np.float32)}}
    got, gn = optim.clip_by_global_norm(tree_map(torch.tensor, tree), 0.5)
    want, jgn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 0.5)
    _close(gn, jgn, "global norm")
    _close(got["x"], want["x"], "clipped x")
    _close(got["y"]["z"], want["y"]["z"], "clipped z")


def test_cosine_schedule_matches_jax():
    f = schedules.cosine_schedule(peak=1.0, warmup=10, total=100, floor=0.1)
    jf = jsched.cosine_schedule(peak=1.0, warmup=10, total=100, floor=0.1)
    assert float(f(0)) < 0.2
    np.testing.assert_allclose(float(f(10)), 1.0, atol=1e-5)
    np.testing.assert_allclose(float(f(100)), 0.1, atol=1e-3)
    vals = [float(f(i)) for i in range(10, 101, 10)]
    assert all(a >= b - 1e-6 for a, b in zip(vals, vals[1:]))
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    _close([float(f(torch.tensor(s, dtype=torch.int32))) for s in steps],
           [float(jf(s)) for s in steps], "cosine")


def test_pres_schedule_matches_jax():
    """eta_t = mu / (L sqrt(K t)), Theorem 2."""
    f = schedules.pres_schedule(mu=0.5, lipschitz=2.0, n_batches=16)
    jf = jsched.pres_schedule(mu=0.5, lipschitz=2.0, n_batches=16)
    np.testing.assert_allclose(float(f(4)), 0.5 / (2.0 * np.sqrt(64)),
                               rtol=1e-6)
    assert float(f(9)) < float(f(4))
    f2 = schedules.pres_schedule(mu=0.5, lipschitz=2.0, n_batches=64)
    assert float(f2(4)) < float(f(4))
    steps = [0, 1, 2, 7, 100]
    _close([float(f(s)) for s in steps], [float(jf(s)) for s in steps],
           "pres schedule")


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_callable_lr_matches_jax(name):
    """A schedule as lr, called with the optimizer's device-side step
    (a 0-d tensor: no host sync), follows JAX's iterates."""
    sched = schedules.cosine_schedule(peak=0.2, warmup=3, total=20)
    jsch = jsched.cosine_schedule(peak=0.2, warmup=3, total=20)
    seen = []

    def lr(step):
        seen.append(step)
        return sched(step)

    got, state = _port_run(optim.OPTIMIZERS[name](lr), _start(), 12)
    want, jstate = _jax_run(jopt.OPTIMIZERS[name](jsch), _start(), 12)
    assert all(isinstance(s, torch.Tensor) and s.dim() == 0 for s in seen)
    assert [int(s) for s in seen] == list(range(1, 13))
    assert int(state["step"]) == int(jstate["step"]) == 12
    _close(got["a"], want["a"], f"{name} a")
    _close(got["b"]["c"], want["b"]["c"], f"{name} b.c")
