"""The port's attention embeddings that run `neighbor_attn` (the dense TGN
stack, `dedup_embed=False`, and APAN's mailbox attention) against the JAX
package on the CPU: the kernel module, the head folding, the dense
frontier expansion, the embeddings, APAN's mailbox, train steps of both
algorithms and APAN serving.

Inputs come from one numpy seed or from JAX's init, moved through
`repro_torch.bridge`; negatives are JAX's draws, injected. The JAX side
runs with use_kernels=True, which on the CPU resolves `neighbor_attn` to
its jitted jnp oracle (and is held against the Pallas kernel in interpret
mode here); the port runs the plain PyTorch versions through the autograd
Functions the card runs.

Tolerances: attention outputs and embeddings 1e-5 of their scale (fp32
sums in another order); gradients 1e-5 relative to each input's largest
gradient (never absolute); rings, mailbox and times exact (copies); loss
1e-5 relative, logits 1e-4, memory table, parameters and first moments
1e-5 of their scale over three steps; serving state 1e-5 and scores 1e-4
(the serve slice's tolerances, tests/test_torch_serve.py)."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.core import batching as jbatching
from repro.graph.negatives import sample_negatives as jsample
from repro.kernels import neighbor_attn as jna
from repro.kernels import ref as jref
from repro.models import embeddings as jemb
from repro.models import mdgnn as jmdgnn
from repro.optim import optimizers as joptim
from repro.serve import MicroBatcher as JBatcher
from repro.serve import ServeEngine as JEngine
from repro.train import loop as jloop

from repro_torch import bridge
from repro_torch.core import batching as tbatching
from repro_torch.graph import events as tevents
from repro_torch.kernels import ops
from repro_torch.models import embeddings as temb
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.serve import MicroBatcher, ServeEngine
from repro_torch.train import loop as tloop

B = 100            # temporal batch size on the 600-event tiny stream


def _f(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


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
    np.testing.assert_array_equal(a["pres"]["n"], b["pres"]["n"])
    _close(a["memory"]["mem"], b["memory"]["mem"], tol, "memory table")
    for k in ("xi", "psi"):
        _close(a["pres"][k], b["pres"][k], 1e-4, f"tracker {k}")


def _tbatch(jb):
    return tevents.EventBatch.from_numpy(
        np.array(jb.src), np.array(jb.dst), np.array(jb.t),
        np.array(jb.feat), np.array(jb.mask), "cpu")


def _dst(spec):
    return (spec.n_users, spec.n_users + spec.n_items)


def _jcfg(stream, variant, **kw):
    base = dict(variant=variant, n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
                d_embed=16, n_neighbors=4, mailbox_size=3, use_kernels=True)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _tcfg(jcfg):
    return tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg))


# ---------------------------------------------------------------------------
# the neighbor_attn kernel module
# ---------------------------------------------------------------------------

# (name, M, K, E, rows with no valid slot)
NA_CASES = [("m1k1", 1, 1, 8, 0), ("invalid", 9, 3, 12, 2),
            ("k16", 21, 16, 64, 1), ("k10_e50", 6, 10, 50, 0)]


def _na_inputs(case, seed=21):
    _, m, kk, e, bad = case
    rng = np.random.default_rng(seed)
    valid = rng.random((m, kk)) < 0.7
    valid[:bad] = False
    return [_f(rng, m, e), _f(rng, m, kk, e), _f(rng, m, kk, e), valid]


@pytest.mark.parametrize("case", NA_CASES, ids=[c[0] for c in NA_CASES])
def test_neighbor_attn_matches_jax(case):
    args = _na_inputs(case)
    jargs = [jnp.asarray(a) for a in args]
    want_pl = jna._neighbor_attn_pallas(*jargs, interpret=True)
    want = jax.jit(jref.neighbor_attn_ref)(*jargs)
    targs = [torch.as_tensor(a) for a in args]
    got = ops.neighbor_attn(*targs).numpy()
    _close(got, want_pl, 1e-5, "vs Pallas")
    _close(got, want, 1e-5, "vs jnp oracle")
    assert (got[:case[4]] == 0).all()        # all-invalid rows are exactly 0
    as_int8 = ops.neighbor_attn(*targs[:3], targs[3].to(torch.int8))
    np.testing.assert_array_equal(as_int8.numpy(), got)


@pytest.mark.parametrize("case", NA_CASES[1:], ids=[c[0] for c in
                                                    NA_CASES[1:]])
def test_neighbor_attn_grads_match_jax(case):
    """The Function's gradients against jitted jax.vjp of the oracle; the
    mask takes none."""
    args = _na_inputs(case)
    ct = _f(np.random.default_rng(22), case[1], case[3])
    jg = jax.jit(lambda a, c: jax.vjp(jref.neighbor_attn_ref, *a)[1](c))(
        [jnp.asarray(a) for a in args], jnp.asarray(ct))
    targs = [torch.as_tensor(a) for a in args]
    for t in targs[:3]:
        t.requires_grad_(True)
    ops.neighbor_attn(*targs).backward(torch.as_tensor(ct))
    for t, w, name in zip(targs[:3], jg, "qkv"):
        _close(t.grad.numpy(), w, 1e-5, f"d{name}")


@pytest.mark.parametrize("heads", [1, 2])
def test_neighbor_attention_heads_match_jax(heads):
    """The head folding around the kernel, forward and gradients."""
    rng = np.random.default_rng(23)
    m, kk, e = 7, 5, 16
    valid = rng.random((m, kk)) < 0.6
    valid[0] = False
    args = [_f(rng, m, e), _f(rng, m, kk, e), _f(rng, m, kk, e), valid]
    cfg = jmdgnn.MDGNNConfig(variant="tgn", n_nodes=10, d_edge=4,
                             d_embed=e, n_heads=heads, use_kernels=True)
    fn = lambda q, k, v: jemb.neighbor_attention(q, k, v,
                                                 jnp.asarray(valid), cfg)
    ct = _f(rng, m, e)
    want, jg = jax.jit(lambda a, c: (fn(*a), jax.vjp(fn, *a)[1](c)))(
        [jnp.asarray(a) for a in args[:3]], jnp.asarray(ct))
    targs = [torch.as_tensor(a).requires_grad_(True) for a in args[:3]]
    got = temb.neighbor_attention(*targs, torch.as_tensor(valid),
                                  _tcfg(cfg))
    _close(got.detach().numpy(), want, 1e-5, "output")
    got.backward(torch.as_tensor(ct))
    for t, w, name in zip(targs, jg, "qkv"):
        _close(t.grad.numpy(), w, 1e-5, f"d{name}")


# ---------------------------------------------------------------------------
# dense frontiers, dense TGN and APAN embeddings, the mailbox
# ---------------------------------------------------------------------------


def _random_state(jcfg, seed=24):
    """A JAX state with random memory, partly filled rings and (APAN) a
    filled mailbox, as numpy."""
    rng = np.random.default_rng(seed)
    n, kk = jcfg.n_nodes, jcfg.n_neighbors
    st = _jstate_np(jmdgnn.init_state(jcfg))
    st["memory"]["mem"] = _f(rng, n, jcfg.d_mem)
    st["memory"]["last_update"] = (rng.random(n) * 50).astype(np.float32)
    nbr = rng.integers(0, n, (n, kk)).astype(np.int32)
    nbr[rng.random((n, kk)) < 0.3] = -1
    nbr[3] = -1                                  # a node with no neighbour
    st["neighbors"] = {"nbr": nbr,
                       "t": (rng.random((n, kk)) * 50).astype(np.float32),
                       "ptr": rng.integers(0, kk, n).astype(np.int32)}
    if "mailbox" in st:
        st["mailbox"]["msg"] = _f(rng, *st["mailbox"]["msg"].shape)
    return st


def _jax_state(st):
    from repro.core.pres import PresState
    from repro.models.modules import MemoryState
    out = {"memory": MemoryState(**{k: jnp.asarray(v) for k, v in
                                    st["memory"].items()}),
           "neighbors": {k: jnp.asarray(v) for k, v in
                         st["neighbors"].items()},
           "pres": PresState(**{k: jnp.asarray(v) for k, v in
                                st["pres"].items()})}
    if "mailbox" in st:
        out["mailbox"] = {k: jnp.asarray(v) for k, v in st["mailbox"].items()}
    return out


def test_expand_frontiers_matches_jax(tiny_stream):
    jcfg = _jcfg(tiny_stream, "tgn")
    st = _random_state(jcfg)
    nodes = np.array([0, 3, 5, 3, 70], np.int32)
    tq = np.linspace(10, 60, 5).astype(np.float32)
    want = jbatching.expand_frontiers(_jax_state(st)["neighbors"],
                                      jnp.asarray(nodes), jnp.asarray(tq), 3)
    got = tbatching.expand_frontiers(
        bridge.state_from_numpy(st, "cpu")["neighbors"],
        torch.as_tensor(nodes).long(), torch.as_tensor(tq), 3)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert got[3]["nodes"].shape == (5 * 4 ** 3,)


@pytest.mark.parametrize("variant,n_layers,heads", [
    ("tgn", 1, 2), ("tgn", 2, 2), ("tgn", 2, 1), ("apan", 1, 2),
    ("apan", 2, 1)])
def test_embeddings_match_jax(tiny_stream, variant, n_layers, heads):
    """Dense TGN (dedup_embed=False) at depth 1 and 2 and APAN at one and
    two stacked layers, one or two heads."""
    jcfg = _jcfg(tiny_stream, variant, n_layers=n_layers, n_heads=heads,
                 dedup_embed=False)
    st = _random_state(jcfg)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(1), jcfg)
    nodes = np.array([0, 3, 5, 3, 70, 79, 12], np.int32)
    tq = np.linspace(10, 60, 7).astype(np.float32)
    want = jax.jit(functools.partial(jmdgnn.embed_nodes, cfg=jcfg))(
        jparams, state=_jax_state(st), nodes=jnp.asarray(nodes),
        t_query=jnp.asarray(tq))
    got = tmdgnn.embed_nodes(
        bridge.params_from_numpy(jax.tree.map(np.array, jparams), "cpu"),
        _tcfg(jcfg), bridge.state_from_numpy(st, "cpu"),
        torch.as_tensor(nodes).long(), torch.as_tensor(tq))
    _close(got.numpy(), want, 1e-5, f"{variant} embeddings")
    assert float(got.abs().max()) > 0.0


def test_update_mailbox_matches_jax(tiny_stream):
    """More occurrences of one node in a call than the mailbox holds: the
    last `mailbox_size` win, in order (ROADMAP Queue 3 P4), as in JAX."""
    jcfg = _jcfg(tiny_stream, "apan")
    st = _random_state(jcfg)
    rng = np.random.default_rng(25)
    m = 12
    nodes = rng.integers(0, 6, m).astype(np.int32)
    nodes[[1, 4, 5, 8, 10]] = 2                  # 5 > mailbox_size = 3
    msgs, times = _f(rng, m, jcfg.d_msg), np.arange(m, dtype=np.float32)
    mask = rng.random(m) < 0.9
    want = jmdgnn.update_mailbox(jcfg, _jax_state(st)["mailbox"],
                                 jnp.asarray(nodes), jnp.asarray(msgs),
                                 jnp.asarray(times), jnp.asarray(mask))
    tstate = bridge.state_from_numpy(st, "cpu")
    tmdgnn.update_mailbox(tstate["mailbox"], torch.as_tensor(nodes).long(),
                          torch.as_tensor(msgs), torch.as_tensor(times),
                          torch.as_tensor(mask))
    got = bridge.state_to_numpy(tstate)["mailbox"]
    for k in ("msg", "t", "ptr"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# train steps: Alg. 1 and Alg. 2 for dense TGN and for APAN
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jloop.make_train_step(jcfg, joptim.adamw(1e-3))


@pytest.mark.parametrize("use_pres", [True, False], ids=["pres", "std"])
@pytest.mark.parametrize("variant", ["tgn_dense", "apan"])
def test_train_steps_match_jax(tiny_stream, tiny_spec, variant, use_pres):
    """Three lag-one steps: loss, logits, state (mailbox included),
    parameters and first moments after each."""
    if variant == "apan":
        jcfg = _jcfg(tiny_stream, "apan", use_pres=use_pres)
    else:
        jcfg = _jcfg(tiny_stream, "tgn", use_pres=use_pres, n_layers=2,
                     dedup_embed=False)
    tcfg = _tcfg(jcfg)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jmdgnn.init_state(jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams), "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    jopt, topt = joptim.adamw(1e-3), toptim.adamw(1e-3)
    jos, tos = jopt.init(jparams), topt.init(tparams)
    jstep, tstep = _jax_step(jcfg), tloop.make_train_step(tcfg, topt)
    jb = tiny_stream.temporal_batches(B)
    dst = _dst(tiny_spec)
    ops.reset_launch_counts()
    for i in range(1, 4):
        neg = jsample(jax.random.PRNGKey(i), jb[i], *dst)
        jparams, jos, jstate, jm = jstep(jparams, jos, jstate, jb[i - 1],
                                         jb[i], neg)
        tparams, tos, tstate, tm = tstep(tparams, tos, tstate,
                                         _tbatch(jb[i - 1]), _tbatch(jb[i]),
                                         _tbatch(neg))
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-5 * abs(want)
        for k in ("logit_p", "logit_n"):
            _close(tm[k].numpy(), jm[k], 1e-4, k)
        _assert_state(tstate, jstate, 1e-5)
        _assert_tree(tparams, jparams, 1e-5, "param")
        _assert_tree(tos["mu"], jos["mu"], 1e-5, "mu", floor=0.0)
    assert float(tos["mu"]["emb"]["l0"]["wk"].abs().max()) > 0.0
    if variant == "apan":
        assert float(tstate["mailbox"]["msg"].abs().max()) > 0.0
    assert not tstate["memory"].mem.requires_grad


# ---------------------------------------------------------------------------
# APAN serving
# ---------------------------------------------------------------------------


def test_apan_serving_matches_jax(tiny_stream, tiny_spec):
    """ServeEngine ingest (memory, rings, trackers, mailbox) and query of
    APAN against the JAX engine."""
    dst = _dst(tiny_spec)
    jcfg = _jcfg(tiny_stream, "apan", use_pres=True)
    params, _ = jmdgnn.init_params(jax.random.PRNGKey(3), jcfg)
    state = jmdgnn.init_state(jcfg)
    np_params, np_state = jax.tree.map(np.array, params), _jstate_np(state)
    buckets = (16, 64)
    je = JEngine(jcfg, params, state, item_range=dst,
                 batcher=JBatcher(buckets=buckets, d_edge=jcfg.d_edge))
    te = ServeEngine(_tcfg(jcfg), bridge.params_from_numpy(np_params, "cpu"),
                     bridge.state_from_numpy(np_state, "cpu"),
                     item_range=dst, device="cpu",
                     batcher=MicroBatcher(buckets=buckets,
                                          d_edge=jcfg.d_edge))
    te.warmup(topk_k=3)
    s, d, t, f = (tiny_stream.src, tiny_stream.dst, tiny_stream.t,
                  tiny_stream.feat)
    lo = 0
    for n in (40, 3, 64, 17):
        je.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        te.ingest(s[lo:lo + n], d[lo:lo + n], t[lo:lo + n], f[lo:lo + n])
        lo += n
        _assert_state(te.state, je.state, 1e-5)
    q = slice(lo, lo + 30)
    _close(te.query(s[q], d[q], t[q]), je.query(s[q], d[q], t[q]), 1e-4,
           "query scores")
    jv, _ = je.recommend_topk(s[lo:lo + 4], t[lo:lo + 4], 5)
    tv, _ = te.recommend_topk(s[lo:lo + 4], t[lo:lo + 4], 5)
    _close(tv, jv, 1e-4, "top-k scores")
