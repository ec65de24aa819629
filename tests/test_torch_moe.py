"""The port's Mixture-of-Experts (`nn/moe.py`) and MoE family
(`archs/moe_arch.py`: arctic-480b, kimi-k2-1t-a32b) against the JAX
package.

`moe()` is held against JAX's with the capacity engaged
(`capacity_factor` 0.5, so that assignments are dropped): the routing ids
equal, the ranks, keep mask and slots equal, the output and the aux loss
within 1e-5 * max(1, |ref|), and the gradients of the router, the experts
and the input against jitted `jax.vjp`. The routing is compared exactly,
so each case first asserts that no two of a token's k + 1 largest router
probabilities lie within 1e-5 of each other: a different top-k set there
is a fault, not a tie (`jax.lax.top_k` returns the lower index first on
ties, `torch.topk` promises no order). The reduced arctic (dense residual
branch) and kimi (first layer dense, one shared expert) run in both
parameter layouts: forward, the last-position prefill, `loss_fn` with its
aux and 4 decode steps against JAX's jitted ones, with JAX's parameters
carried over by `bridge.zoo_params_from_numpy`."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.archs import api as japi
from repro.configs import get_config as jget_config
from repro.nn import moe as jmoe
from repro.nn.module import ParamBuilder as JParamBuilder

from repro_torch import bridge
from repro_torch.archs import api
from repro_torch.configs import get_config
from repro_torch.nn import moe

TOL = 1e-5
MARGIN = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, name, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{name}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_routing(router, xt, top_k, cf):
    """JAX's routing and slot assignment, the lines of
    `repro/nn/moe.py::moe` that its output does not return."""
    t = xt.shape[0]
    n_experts = router.shape[-1]
    topp, topi, probs = jmoe._topk_route(xt @ router, top_k)
    cap = int(max(1, round(t * top_k / n_experts * cf)))
    flat_e = topi.reshape(-1)
    tk = t * top_k
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(n_experts))
    rank_sorted = jnp.arange(tk) - start[sorted_e]
    rank = jnp.zeros(tk, jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))
    keep = rank < cap
    dest = jnp.where(keep, flat_e * cap + rank, n_experts * cap)
    return dict(topi=topi, topp=topp, probs=probs, cap=cap, rank=rank,
                keep=keep, dest=dest)


def _min_margin(probs, k):
    """The smallest gap between consecutive ones of each token's k + 1
    largest probabilities."""
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


def _moe_case(seed, d=32, f=48, n_experts=4, b=2, s=16):
    jb = JParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jmoe.moe_init(jb, "moe", d, f, n_experts)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (b, s, d)), np.float32)
    return jb.params["moe"], x


@pytest.mark.parametrize("top_k,cf", [(2, 0.5), (1, 0.5), (2, 1.25)],
                         ids=["top2-drop", "top1-drop", "top2"])
def test_moe_routing_and_output_match_jax(top_k, cf):
    jp, x = _moe_case(0)
    xt = x.reshape(-1, x.shape[-1])
    want = _jax_routing(jp["router"], jnp.asarray(xt), top_k, cf)
    assert _min_margin(want["probs"], top_k) > MARGIN
    pt = bridge.zoo_params_from_numpy(_jtree(jp), "cpu")
    topp, topi, probs = moe._topk_route(_t(xt) @ pt["router"], top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want["topi"]))
    _close(topp, want["topp"], "topp")
    _close(probs, want["probs"], "probs")
    cap = moe.capacity(xt.shape[0], top_k, 4, cf)
    assert cap == want["cap"]
    rank, keep, dest = moe.dispatch_slots(topi, 4, cap)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want["rank"]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want["dest"]))
    if cf < 1.0:
        assert not bool(keep.all()), "the capacity dropped nothing"

    jy, jaux = jax.jit(lambda p, a: jmoe.moe(p, a, top_k=top_k,
                                             capacity_factor=cf))(jp, x)
    y, aux = moe.moe(pt, _t(x), top_k=top_k, capacity_factor=cf)
    _close(y, jy, "moe output")
    _close(aux, jaux, "aux loss")


def test_moe_grads_match_jax():
    """The gradients of the router, wi / wg / wo and the input, from
    random cotangents of the output and the aux loss, with assignments
    dropped (capacity_factor 0.5)."""
    jp, x = _moe_case(3)
    rng = np.random.default_rng(5)
    dy = rng.normal(size=x.shape).astype(np.float32)
    daux = np.float32(0.7)
    fn = lambda p, a: jmoe.moe(p, a, top_k=2, capacity_factor=0.5)
    (_, _), vjp = jax.vjp(jax.jit(fn), jp, jnp.asarray(x))
    jgp, jgx = jax.jit(vjp)((jnp.asarray(dy), jnp.asarray(daux)))
    xt = x.reshape(-1, x.shape[-1])
    routing = _jax_routing(jp["router"], jnp.asarray(xt), 2, 0.5)
    assert _min_margin(routing["probs"], 2) > MARGIN

    pt = bridge.zoo_params_from_numpy(_jtree(jp), "cpu")
    for v in pt.values():
        v.requires_grad_(True)
    xt_ = _t(x).requires_grad_(True)
    y, aux = moe.moe(pt, xt_, top_k=2, capacity_factor=0.5)
    names = sorted(pt)
    grads = torch.autograd.grad([y, aux], [pt[n] for n in names] + [xt_],
                                [_t(dy), torch.tensor(daux)])
    for n, g in zip(names, grads):
        _close(g, jgp[n], f"d{n}")
    _close(grads[-1], jgx, "dx")


def test_moe_expert_slices_equal_whole():
    """Experts cast and run a slice at a time (bf16 weights, fp32
    activations, CAST_BYTES small enough for one expert a slice) give
    what casting the weights whole gives."""
    jp, x = _moe_case(7)
    pt = {k: v.to(torch.bfloat16)
          for k, v in bridge.zoo_params_from_numpy(_jtree(jp), "cpu").items()}
    whole = moe.moe({k: v.float() for k, v in pt.items()}, _t(x), top_k=2)
    saved = moe.CAST_BYTES
    moe.CAST_BYTES = 1
    try:
        sliced = moe.moe(pt, _t(x), top_k=2)
    finally:
        moe.CAST_BYTES = saved
    assert torch.equal(whole[0], sliced[0])
    assert torch.equal(whole[1], sliced[1])


# ---------------------------------------------------------------------------
# the reduced MoE models
# ---------------------------------------------------------------------------

MODELS = ["arctic-480b", "kimi-k2-1t-a32b"]
S = 64
DECODE_STEPS = 4


@pytest.mark.parametrize("scan", [False, True], ids=["units", "stacked"])
@pytest.mark.parametrize("arch", MODELS)
def test_reduced_moe_model_matches_jax(arch, scan):
    """attn_chunk=32 at S = 64: the attention takes the blockwise branch
    (flash_attn)."""
    kw = dict(scan_layers=scan, attn_chunk=32)
    jcfg = jget_config(arch).reduced(**kw)
    jmodel = japi.get_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    key1, key2 = jax.random.split(jax.random.PRNGKey(1))
    toks = np.asarray(jax.random.randint(key1, (2, S), 0, jcfg.vocab),
                      np.int32)
    tgts = np.asarray(jax.random.randint(key2, (2, S), 0, jcfg.vocab),
                      np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    want = jax.jit(jmodel.forward)(jparams, jbatch)
    jloss, jaux = jax.jit(jmodel.loss_fn)(jparams, jbatch)

    cfg = get_config(arch).reduced(**kw)
    model = api.get_model(cfg)
    params = bridge.zoo_params_from_numpy(_jtree(jparams), "cpu")
    batch = {"tokens": _t(toks), "targets": _t(tgts)}
    with torch.no_grad():
        got = model.forward(params, batch)
        last = model.prefill(params, batch)
        loss, aux = model.loss_fn(params, batch)
    _close(got, want, f"{arch} forward")
    _close(last, np.asarray(want)[:, -1], f"{arch} prefill")
    _close(loss, jloss, f"{arch} loss")
    _close(aux["aux"], jaux["aux"], f"{arch} aux")
    assert float(aux["aux"]) > 0.0

    jstate = jmodel.init_decode_state(2, 16)
    jstep = jax.jit(jmodel.decode_step)
    with torch.no_grad():
        state = model.init_decode_state(2, 16, "cpu")
        for i in range(DECODE_STEPS):
            tok = toks[:, i:i + 1]
            jl, jstate = jstep(jparams, jstate, jnp.asarray(tok),
                               jnp.asarray(i, jnp.int32))
            lg, state = model.decode_step(params, state, _t(tok), i)
            _close(lg, jl, f"{arch} decode step {i}")


def test_moe_configs_match_jax():
    """The published configs and their reduced forms, field by field."""
    for arch in MODELS:
        for cut in (False, True):
            j, p = jget_config(arch), get_config(arch)
            if cut:
                j, p = j.reduced(), p.reduced()
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab", "n_experts", "top_k",
                      "dense_residual", "first_dense", "n_shared_experts",
                      "capacity_factor", "moe_aux_weight", "rope_theta",
                      "tie_embeddings", "remat", "scan_layers", "max_seq"):
                assert getattr(p, f) == getattr(j, f), (arch, cut, f)
