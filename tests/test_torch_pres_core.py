"""The rest of PRES's core in the port (`repro_torch.core.pres`,
`core/coherence.py`, `core/theory.py`), the sequential memory oracle,
the node decoder and labels, and per-step APs, against the JAX package on
the CPU.

Inputs come from one numpy seed, the same on both sides. The sampled
branch of `predict` cannot match jax.random's bits: its draws are held to
the GMM that JAX's `PresState.gmm` computes from the same trackers,
within five standard errors over 20,000 draws (the chance of a false
failure is below 1e-5 a bound), and JAX's own draws are held to the same
bounds. `make_anchor_mask` likewise, against binomial bounds.

Tolerances: the filter, corrections and means 1e-6 of their scale (a few
fp32 operations a row); tracker sums 1e-5 (sums in another order) and
counts exact; coherence values 1e-6; Def. 3's probe 1e-5 (two gradients);
the theory functions 1e-9 relative (float64 on both sides); the
sequential oracle's table 1e-5 after its events (as the batch-parallel
update's, tests/test_torch_train.py), times exact; node logits 1e-5;
labels byte for byte; per-step APs equal to the AP of each step's logits
(the same numbers in another order of work)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax
import jax.numpy as jnp

from repro.core import coherence as jcoherence
from repro.core import pres as jpres
from repro.core import theory as jtheory
from repro.graph import datasets as jdatasets
from repro.graph.events import EventBatch as JBatch
from repro.models import mdgnn as jmdgnn

from repro_torch import bridge
from repro_torch.core import coherence as tcoherence
from repro_torch.core import pres as tpres
from repro_torch.core import theory as ttheory
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph import events as tevents
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.optim import optimizers as toptim
from repro_torch.train import loop as tloop
from repro_torch.utils import metrics as tmetrics

D = 6


def _close(got, want, tol, what, floor=1.0):
    """|got - want| <= tol * max(floor, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    lim = tol * max(floor, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= lim, f"{what}: max |port - jax| = {err:.3g} > {lim:.3g}"


def _trackers(rng, rows, d=D):
    """Tracker sums of a few deltas a row (some rows empty), as numpy."""
    cnt = rng.integers(0, 5, (rows, 2)).astype(np.float32)
    mu = rng.normal(size=(rows, 2, d)).astype(np.float32)
    xi = (mu * cnt[..., None]).astype(np.float32)
    psi = ((mu ** 2 + rng.uniform(0.1, 1, (rows, 2, d)))
           * cnt[..., None]).astype(np.float32)
    return cnt, xi, psi


def _both(cnt, xi, psi):
    """JAX's PresState and the port's (with its dump row)."""
    j = jpres.PresState(n=jnp.asarray(cnt), xi=jnp.asarray(xi),
                        psi=jnp.asarray(psi))
    dump = lambda a: torch.tensor(np.concatenate(
        [a, np.zeros((1,) + a.shape[1:], a.dtype)]))
    return j, tpres.PresState(n=dump(cnt), xi=dump(xi), psi=dump(psi))


def _assert_trackers(t, j, tol=1e-5):
    rows = t.rows()
    np.testing.assert_array_equal(rows.n.numpy(), np.asarray(j.n))
    _close(rows.xi.numpy(), j.xi, tol, "xi")
    _close(rows.psi.numpy(), j.psi, tol, "psi")


# ---------------------------------------------------------------------------
# PRES: correct, filter_memory, update_trackers, the anchor mask, means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logit", [-2.0, 0.0, 1.5])
def test_correct_matches_jax(logit):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(9, D)).astype(np.float32) for _ in range(2))
    want = jpres.correct({"gamma_logit": jnp.float32(logit)}, a, b)
    got = tpres.correct({"gamma_logit": torch.tensor(logit)},
                        torch.tensor(a), torch.tensor(b))
    _close(got.numpy(), want, 1e-6, "correct")


@pytest.mark.parametrize("anchored", [False, True], ids=["all", "anchor"])
@pytest.mark.parametrize("delta_mode", ["innovation", "transition"])
def test_filter_memory_matches_jax(delta_mode, anchored):
    """Predict, correct, the delta rate and the tracker update over rows
    with repeated nodes, masked rows, both event types, zero and large
    time gaps, with and without an anchor mask."""
    rng = np.random.default_rng(2)
    rows, m = 10, 40
    jstate, tstate = _both(*_trackers(rng, rows))
    nodes = rng.integers(0, rows, m).astype(np.int32)
    s_prev, s_meas = (rng.normal(size=(m, D)).astype(np.float32)
                      for _ in range(2))
    t_prev = rng.uniform(0, 10, m).astype(np.float32)
    t_now = (t_prev + rng.choice([0.0, 0.5, 3.0, 40.0], m)).astype(np.float32)
    etype = rng.integers(0, 2, m).astype(np.int32)
    mask = rng.random(m) < 0.8
    anchor = rng.random(rows) < 0.5 if anchored else None
    params = {"gamma_logit": np.float32(0.3)}
    kw = dict(nodes=nodes, s_prev=s_prev, s_meas=s_meas, t_prev=t_prev,
              t_now=t_now, etype=etype, mask=mask, delta_mode=delta_mode)
    want, jnew = jpres.filter_memory(
        jax.tree.map(jnp.asarray, params), jstate, anchor_mask=anchor,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw["nodes"] = tkw["nodes"].long()
    tkw["etype"] = tkw["etype"].long()
    got, tnew = tpres.filter_memory(
        {"gamma_logit": torch.tensor(0.3)}, tstate,
        anchor_mask=None if anchor is None else torch.tensor(anchor), **tkw)
    assert tnew is tstate
    _close(got.numpy(), want, 1e-6, "fused rows")
    _assert_trackers(tnew, jnew)
    if anchored:
        untouched = ~anchor
        assert (tnew.rows().n.numpy()[untouched]
                == _trackers(np.random.default_rng(2), rows)[0][untouched]
                ).all()
    with pytest.raises(ValueError):
        tpres.filter_memory({"gamma_logit": torch.tensor(0.0)}, tstate,
                            **dict(tkw, delta_mode="bogus"))


def test_update_trackers_anchor_mask_matches_jax():
    rng = np.random.default_rng(3)
    rows, m = 7, 30
    jstate, tstate = _both(*_trackers(rng, rows))
    nodes = rng.integers(0, rows, m)
    delta = rng.normal(size=(m, D)).astype(np.float32)
    etype = rng.integers(0, 2, m)
    mask = rng.random(m) < 0.7
    anchor = np.array([True, False, True, True, False, False, True])
    jnew = jpres.update_trackers(jstate, jnp.asarray(nodes, jnp.int32),
                                 jnp.asarray(delta),
                                 jnp.asarray(etype, jnp.int32),
                                 jnp.asarray(mask), anchor_mask=anchor)
    tpres.update_trackers(tstate, torch.tensor(nodes), torch.tensor(delta),
                          torch.tensor(etype), torch.tensor(mask),
                          anchor_mask=torch.tensor(anchor))
    _assert_trackers(tstate, jnew)


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.9])
def test_make_anchor_mask_fraction(fraction):
    """The anchored share of 10,000 rows within five binomial standard
    deviations of `fraction` (JAX's mask too), and the seed decides it."""
    n = 10_000
    sd = np.sqrt(n * fraction * (1 - fraction))
    got = tpres.make_anchor_mask(torch.Generator().manual_seed(0), n,
                                 fraction)
    want = jpres.make_anchor_mask(jax.random.PRNGKey(0), n, fraction)
    assert got.dtype == torch.bool and got.shape == (n,)
    for mask in (got.numpy(), np.asarray(want)):
        assert abs(int(mask.sum()) - n * fraction) <= 5 * sd
    again = tpres.make_anchor_mask(torch.Generator().manual_seed(0), n,
                                   fraction)
    assert torch.equal(got, again)


@pytest.mark.parametrize("buckets", [3, 10])
def test_mixture_mean_rows_matches_jax(buckets):
    """Every node's mixture mean: per node (buckets == nodes) or from
    hashed trackers, bucket node % buckets."""
    rng = np.random.default_rng(4)
    jstate, tstate = _both(*_trackers(rng, buckets))
    n = 10
    want = jpres.mixture_mean(jstate, jnp.arange(n) % buckets)
    _close(tpres.mixture_mean_rows(tstate, n).numpy(), want, 1e-6,
           "mixture means")
    s_prev = rng.normal(size=(n, D)).astype(np.float32)
    dt = rng.uniform(0, 3, n).astype(np.float32)
    want = jpres.predict(jstate, s_prev, dt, jnp.arange(n) % buckets,
                         clip=1.0)
    got = tpres.predict(tstate, torch.tensor(s_prev), torch.tensor(dt),
                        clip=1.0)
    _close(got.numpy(), want, 1e-6, "predict over all nodes")


def test_sampled_predict_matches_gmm_distribution():
    """20,000 draws of the sampled branch (dt = 1, no clip hit), the port's
    and JAX's: the share of each component against alpha, and each
    component's mean and variance and the mixture mean against the GMM
    of JAX's PresState.gmm. The components sit 10 standard deviations
    apart in dimension 0, so a draw's component is read off its sign."""
    n_draws, d = 20_000, 3
    cnt = np.array([[3.0, 1.0], [1.0, 4.0]], np.float32)
    mu = np.array([[[5.0, 0.5, -1.0], [-5.0, 2.0, 0.0]],
                   [[5.0, -0.5, 1.0], [-5.0, 0.0, 3.0]]], np.float32)
    var = np.array([[[0.25, 1.0, 0.5], [0.25, 0.3, 2.0]],
                    [[0.25, 0.7, 1.5], [0.25, 1.2, 0.1]]], np.float32)
    xi = mu * cnt[..., None]
    psi = (var + mu ** 2) * cnt[..., None]
    jstate, tstate = _both(cnt, xi, psi)
    alpha, gmu, gvar = (np.asarray(a, np.float64) for a in jstate.gmm())
    nodes = np.repeat(np.arange(2), n_draws // 2)
    s_prev = np.zeros((n_draws, d), np.float32)
    dt = np.ones(n_draws, np.float32)
    gen = torch.Generator().manual_seed(0)
    draws = {"port": tpres.predict(tstate, torch.tensor(s_prev),
                                   torch.tensor(dt), torch.tensor(nodes),
                                   generator=gen, clip=100.0).numpy(),
             "jax": np.asarray(jpres.predict(
                 jstate, s_prev, dt, jnp.asarray(nodes, jnp.int32),
                 key=jax.random.PRNGKey(0), clip=100.0))}
    for side, x in draws.items():
        assert np.isfinite(x).all(), side
        for node in range(2):
            xs = x[nodes == node].astype(np.float64)
            m = xs.shape[0]
            comp = (xs[:, 0] < 0).astype(int)
            share = comp.mean()
            a1 = alpha[node, 1]
            assert abs(share - a1) <= 5 * np.sqrt(a1 * (1 - a1) / m), side
            mix = alpha[node] @ gmu[node]
            tot = alpha[node] @ (gvar[node] + gmu[node] ** 2) - mix ** 2
            assert (np.abs(xs.mean(0) - mix)
                    <= 5 * np.sqrt(tot / m)).all(), side
            for k in range(2):
                xk = xs[comp == k]
                mk = xk.shape[0]
                assert (np.abs(xk.mean(0) - gmu[node, k])
                        <= 5 * np.sqrt(gvar[node, k] / mk)).all(), side
                assert (np.abs(xk.var(0, ddof=1) - gvar[node, k])
                        <= 5 * gvar[node, k] * np.sqrt(2 / (mk - 1))
                        ).all(), side


def test_sampled_predict_is_a_function_of_the_generator():
    """Two draws from generators of one seed are bit for bit equal (JAX's
    draw is a pure function of its key), over two 5,000-row blocks of the
    distribution test's trackers; another seed gives other draws."""
    n_draws, d = 10_000, 3
    rng = np.random.default_rng(5)
    cnt, xi, psi = _trackers(rng, 2, d)
    cnt[:, 0] += 1.0                    # both rows hold some events
    _, tstate = _both(cnt, xi, psi)
    nodes = torch.tensor(np.repeat(np.arange(2), n_draws // 2))
    s_prev = torch.tensor(rng.normal(size=(n_draws, d)).astype(np.float32))
    dt = torch.ones(n_draws)
    draw = lambda seed: tpres.predict(
        tstate, s_prev, dt, nodes, clip=100.0,
        generator=torch.Generator().manual_seed(seed))
    first = draw(11)
    for _ in range(3):
        again = draw(11)
        diff = (again - first).abs().max(dim=1).values
        assert torch.equal(again, first), (
            f"{int((diff > 0).sum())} rows differ, by up to "
            f"{float(diff.max()):.3g}")
    assert not torch.equal(draw(12), first)


# ---------------------------------------------------------------------------
# coherence and theory
# ---------------------------------------------------------------------------


def test_per_node_coherence_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(30, D)).astype(np.float32)
    b = (a + 0.5 * rng.normal(size=(30, D))).astype(np.float32)
    mask = (rng.random(30) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros(30, np.float32)):
        want = jcoherence.per_node_coherence(
            a, b, mask=None if m is None else jnp.asarray(m))
        got = tcoherence.per_node_coherence(
            torch.tensor(a), torch.tensor(b),
            mask=None if m is None else torch.tensor(m))
        assert abs(float(got) - float(want)) <= 1e-6


def test_empirical_memory_coherence_matches_jax():
    """Def. 3's probe on the decoder loss of a fixed batch: the BCE of the
    link logits of (source row, destination row) pairs, at stale and fresh
    endpoint rows."""
    rng = np.random.default_rng(6)
    e, b = 8, 12
    dec = {"w1": rng.normal(size=(2 * e, e)) / 4, "b1": rng.normal(size=e),
           "w2": rng.normal(size=(e, 1)) / 3, "b2": rng.normal(size=1)}
    dec = {k: v.astype(np.float32) for k, v in dec.items()}
    fresh = rng.normal(size=(2 * b, e)).astype(np.float32)
    stale = (fresh + 0.3 * rng.normal(size=fresh.shape)).astype(np.float32)
    labels = (rng.random(b) < 0.5).astype(np.float32)

    def jloss(params, s):
        logit = jmdgnn.link_logits(params, s[:b], s[b:])
        return jnp.mean(jax.nn.softplus(logit) - labels * logit)

    def tloss(params, s):
        logit = tmdgnn.link_logits(params, s[:b], s[b:])
        return torch.mean(torch.nn.functional.softplus(logit)
                          - torch.tensor(labels) * logit)

    want = jcoherence.empirical_memory_coherence(
        jloss, {"dec": dec}, jnp.asarray(stale), jnp.asarray(fresh))
    tdec = {"dec": {k: torch.tensor(v) for k, v in dec.items()}}
    got = tcoherence.empirical_memory_coherence(
        tloss, tdec, torch.tensor(stale), torch.tensor(fresh))
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    same = tcoherence.empirical_memory_coherence(
        tloss, tdec, torch.tensor(fresh), torch.tensor(fresh))
    assert abs(float(same) - 1.0) <= 1e-6


def test_theory_matches_jax():
    rng = np.random.default_rng(7)
    grads = [{"a": {"w": rng.normal(size=(3, 4))}, "b": rng.normal(size=5)}
             for _ in range(6)]
    want = jtheory.gradient_variance(grads)
    tgrads = [{"a": {"w": torch.tensor(g["a"]["w"])},
               "b": torch.tensor(g["b"])} for g in grads]
    assert abs(ttheory.gradient_variance(tgrads) - want) <= 1e-9 * want
    assert ttheory.theorem1_lower_bound(20_000, 600, 0.37) == \
        jtheory.theorem1_lower_bound(20_000, 600, 0.37)
    for args in [(40, 2.0, 0.5, 1.3, 0.2, 100), (7, 1.0, 0.9, 0.1, 3.0, 1)]:
        t, j = ttheory.theorem2_bound(*args), jtheory.theorem2_bound(*args)
        assert abs(t - j) <= 1e-9 * abs(j)
    epoch_fn = lambda params, batches, gen: ({"g": params["w"] * len(batches)},
                                             gen)
    g, aux = ttheory.epoch_gradient(epoch_fn, {"w": torch.ones(2)}, [0, 1, 2],
                                    "gen")
    assert torch.equal(g["g"], torch.full((2,), 3.0)) and aux == "gen"


# ---------------------------------------------------------------------------
# the sequential oracle, node_logits, node_labels, per-step APs
# ---------------------------------------------------------------------------


def _small_cfg(**kw):
    base = dict(variant="tgn", n_nodes=12, d_edge=4, d_mem=16, d_msg=16,
                d_time=8, d_embed=16, n_neighbors=4)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _events(src, dst, t, mask=None, d_edge=4):
    """The same event batch for JAX and the port."""
    n = len(src)
    feat = np.random.default_rng(42).normal(size=(n, d_edge)).astype(
        np.float32)
    mask = np.ones(n, bool) if mask is None else np.asarray(mask)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    t = np.asarray(t, np.float32)
    jb = JBatch(src=jnp.asarray(src), dst=jnp.asarray(dst),
                t=jnp.asarray(t), feat=jnp.asarray(feat),
                mask=jnp.asarray(mask))
    return jb, tevents.EventBatch.from_numpy(src, dst, t, feat, mask, "cpu")


def _mem_pair(cfg, seed=8):
    rng = np.random.default_rng(seed)
    mem = (rng.normal(size=(cfg.n_nodes, cfg.d_mem)) * 0.5).astype(
        np.float32)
    last = rng.uniform(0, 1, cfg.n_nodes).astype(np.float32)
    return (jmdgnn.MemoryState(mem=jnp.asarray(mem),
                               last_update=jnp.asarray(last)),
            tmdgnn.MemoryState(mem=torch.tensor(mem),
                               last_update=torch.tensor(last)))


@pytest.mark.parametrize("cell", ["gru", "rnn"])
def test_sequential_memory_update_matches_jax(cell):
    """Events that share nodes (pending events) and a masked one, one at a
    time through the plain cell; the port leaves its input state alone."""
    cfg = _small_cfg(memory_cell=cell)
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    jmem, tmem = _mem_pair(cfg)
    before = tmem.mem.clone()
    jb, tb = _events([0, 0, 1, 2, 0], [6, 7, 6, 8, 9],
                     [1.0, 2.0, 2.5, 3.0, 4.0],
                     mask=[True, True, True, False, True])
    want = jmdgnn.sequential_memory_update(jparams, cfg, jmem, jb)
    got = tmdgnn.sequential_memory_update(tparams, tmdgnn.MDGNNConfig(
        **dataclasses.asdict(cfg)), tmem, tb)
    _close(got.mem.numpy(), want.mem, 1e-5, "sequential table")
    np.testing.assert_array_equal(got.last_update.numpy(),
                                  np.asarray(want.last_update))
    assert torch.equal(tmem.mem, before)


def test_no_pending_events_matches_sequential_oracle():
    """Vertex-disjoint events: batch processing is sequential processing,
    so the port's batch-parallel update equals its oracle."""
    cfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(_small_cfg()))
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    _, mem = _mem_pair(cfg)
    _, tb = _events([0, 1, 2], [6, 7, 8], [1.0, 2.0, 3.0])
    seq = tmdgnn.sequential_memory_update(params, cfg, mem, tb)
    par, _ = tmdgnn.memory_update(params, cfg, mem, tb)
    torch.testing.assert_close(par.mem, seq.mem, atol=1e-5, rtol=0)
    torch.testing.assert_close(par.last_update, seq.last_update,
                               atol=1e-6, rtol=0)


def test_node_logits_matches_jax():
    cfg = _small_cfg()
    jparams, _ = jmdgnn.init_params(jax.random.PRNGKey(3), cfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    h = np.random.default_rng(9).normal(size=(20, cfg.d_embed)).astype(
        np.float32)
    want = jmdgnn.node_logits(jparams, jnp.asarray(h))
    got = tmdgnn.node_logits(tparams, torch.tensor(h))
    assert got.shape == (20,)
    _close(got.numpy(), want, 1e-5, "node logits")


@pytest.mark.parametrize("name", ["tiny", "wiki-small"])
def test_node_labels_byte_identical(name, tiny_spec):
    if name == "tiny":
        jspec = tiny_spec
        tspec = tdatasets.SyntheticSpec(**dataclasses.asdict(tiny_spec))
    else:
        jspec, tspec = jdatasets.SPECS[name], tdatasets.SPECS[name]
    for seed in (0, 5):
        a = jdatasets.node_labels(jdatasets.generate(jspec, seed), jspec,
                                  seed)
        b = tdatasets.node_labels(tdatasets.generate(tspec, seed), tspec,
                                  seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("depth", [0, 2])
def test_run_epoch_collects_step_aps(tiny_stream, tiny_spec, depth):
    """collect_logits=True adds each step's AP (computed from the epoch's
    one copy of the logits); without it `aps` is empty."""
    from repro_torch.train import pipeline as tpipeline
    ts = tevents.EventStream(tiny_stream.src, tiny_stream.dst, tiny_stream.t,
                             tiny_stream.feat, tiny_stream.num_nodes)
    cfg = tmdgnn.MDGNNConfig(**dataclasses.asdict(_small_cfg(
        n_nodes=ts.num_nodes, d_edge=ts.feat_dim, use_pres=True,
        pipeline_depth=depth)))
    dst = (tiny_spec.n_users, tiny_spec.n_users + tiny_spec.n_items)
    batches = ts.slice(0, 400).temporal_batches(100, "cpu")
    seen = []
    for collect in (True, False):
        params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt = toptim.adamw(1e-3)
        step = tpipeline.make_train_step(cfg, opt)

        def record(*a):
            out = step(*a)
            seen.append((out[-1]["logit_p"].numpy(),
                         out[-1]["logit_n"].numpy()))
            return out

        res = tpipeline.run_epoch(
            params, opt.init(params), tmdgnn.init_state(cfg, "cpu"), batches,
            cfg, record, torch.Generator().manual_seed(1), dst,
            collect_logits=collect)[-1]
        if collect:
            want = [tmetrics.average_precision(p, n) for p, n in seen]
            assert res.aps == want and len(want) == len(batches) - 1
        else:
            assert res.aps == []
    assert isinstance(res, tloop.EpochResult)
