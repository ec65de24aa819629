"""The port's memory-parallel routing (`repro_torch.train.routing`) against
the JAX package's (`repro.train.routing`) on the CPU.

* the pure functions, element for element at n_shards 1, 2, 3, 4 and 8:
  `phys_index`, `to/from_shard_layout`, and the routing plan
  (`bucket_plan`, `bucket_scatter`, `bucket_gather`) with valid masks,
  padding and tight budgets (overflow counts equal);
* `shard_state` / `unshard_state`: a round trip gives back the
  single-device state exactly, dump rows and hashed trackers included;
  the shards' real rows concatenated are JAX's `to_shard_layout`;
* `get_mesh`: the CPU, one named card, and the ValueError naming the
  visible count on bare "cuda";
* `sharded_memory_and_pres` at n_shards = 1 against JAX's, run in process
  on its one-device mesh (as tests/test_routing.py runs it), on both
  routes; at n_shards 2 and 4 against JAX's single-device
  `loop.memory_and_pres` (the GRU and rnn cells, aggregator="mean",
  pres_scale="time", hashed trackers); a tight `shard_budget`'s
  `route_overflow` equal to JAX's plan of the same occurrences.

Inputs are drawn with numpy from a seed; JAX's parameters and state are
carried over by `repro_torch.bridge`. Tolerance: ATOL = 1e-5 (JAX's
routing suite); flags, ranks, slots and counts exact."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.pres import PresState as JPres
from repro.models import mdgnn as jmdgnn
from repro.models.modules import MemoryState as JMem
from repro.train import loop as jloop
from repro.train import routing as jrouting

from repro_torch import bridge
from repro_torch.graph import events as tevents
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.train import loop as tloop
from repro_torch.train import routing as trouting

ATOL = 1e-5
SHARDS = [1, 2, 3, 4, 8]


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# layout and plan: pure functions, element for element
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_layout_matches_jax(n):
    rng = np.random.default_rng(n)
    n_rows = 37
    ids = np.arange(n_rows)
    np.testing.assert_array_equal(
        trouting.phys_index(torch.as_tensor(ids), n_rows, n).numpy(),
        _np(jrouting.phys_index(ids, n_rows, n)))
    assert trouting.rows_per_shard(n_rows, n) == \
        jrouting.rows_per_shard(n_rows, n)
    assert trouting.padded_rows(n_rows, n) == jrouting.padded_rows(n_rows, n)
    x = rng.normal(size=(n_rows, 3)).astype(np.float32)
    want = jrouting.to_shard_layout(x, n_rows, n)
    np.testing.assert_array_equal(trouting.to_shard_layout(x, n_rows, n),
                                  want)
    got = trouting.to_shard_layout(torch.as_tensor(x), n_rows, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        trouting.from_shard_layout(got, n_rows, n).numpy(), x)
    np.testing.assert_array_equal(trouting.from_shard_layout(want, n_rows, n),
                                  jrouting.from_shard_layout(want, n_rows, n))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("budget", [None, 1, 3])
def test_bucket_plan_matches_jax(n, budget):
    rng = np.random.default_rng(10 * n + (budget or 0))
    m = 24
    owner = rng.integers(0, n, m).astype(np.int32)
    valid = rng.random(m) < 0.7
    valid[-3:] = False                          # padding rows at the end
    b = budget or m
    j_slot, j_rank, j_kept, j_ovf = jrouting.bucket_plan(
        jnp.asarray(owner), jnp.asarray(valid), n, b)
    t_slot, t_rank, t_kept, t_ovf = trouting.bucket_plan(
        torch.as_tensor(owner).long(), torch.as_tensor(valid), n, b)
    np.testing.assert_array_equal(t_slot.numpy(), _np(j_slot))
    np.testing.assert_array_equal(t_rank.numpy(), _np(j_rank))
    np.testing.assert_array_equal(t_kept.numpy(), _np(j_kept))
    assert int(t_ovf) == int(j_ovf)
    assert int(t_kept.sum()) + int(t_ovf) == int(valid.sum())
    x = rng.normal(size=(m, 5)).astype(np.float32)
    j_buf = jrouting.bucket_scatter(jnp.asarray(x), j_slot, n, b, fill=-1.0)
    t_buf = trouting.bucket_scatter(torch.as_tensor(x), t_slot, n, b,
                                    fill=-1.0)
    np.testing.assert_array_equal(t_buf.numpy(), _np(j_buf))
    np.testing.assert_array_equal(
        trouting.bucket_gather(t_buf, torch.as_tensor(owner).long(), t_rank,
                               b, t_kept, fill=7.0).numpy(),
        _np(jrouting.bucket_gather(j_buf, jnp.asarray(owner), j_rank, b,
                                   j_kept, fill=7.0)))
    # a bool payload (the routed valid flags)
    np.testing.assert_array_equal(
        trouting.bucket_scatter(t_kept, t_slot, n, b, False).numpy(),
        _np(jrouting.bucket_scatter(j_kept, j_slot, n, b, False)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_collectives_round_trip(n):
    """all_to_all twice is the identity; psum of one-hot contributions
    assembles every row; all_gather concatenates in shard order."""
    mesh = trouting.get_mesh(n, "cpu")
    xs = [torch.arange(n * 2, dtype=torch.float32) + 100 * s
          for s in range(n)]
    there = trouting.all_to_all(xs, mesh)
    assert there[1][:2].tolist() == xs[0][2:4].tolist()
    back = trouting.all_to_all(there, mesh)
    for a, b in zip(back, xs):
        assert torch.equal(a, b)
    cat = trouting.all_gather(xs, mesh)
    assert all(torch.equal(c, torch.cat(xs)) for c in cat)
    parts = [torch.where(torch.arange(n) == s, torch.tensor(float(s + 1)),
                         torch.tensor(0.0)) for s in range(n)]
    assert trouting.psum(parts, mesh)[0].tolist() == \
        [float(s + 1) for s in range(n)]


# ---------------------------------------------------------------------------
# shard_state / unshard_state
# ---------------------------------------------------------------------------


def _random_state(cfg, seed):
    """A natural-layout port state with every leaf drawn, dump rows too."""
    g = torch.Generator().manual_seed(seed)
    state = tmdgnn.init_state(cfg, "cpu")

    def fill(t):
        if t.dtype == torch.int32:
            t.copy_(torch.randint(-1, 9, t.shape, generator=g,
                                  dtype=torch.int32))
        else:
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))

    for comp in state.values():
        for leaf in (dataclasses.astuple(comp)
                     if dataclasses.is_dataclass(comp) else comp.values()):
            fill(leaf)
    return state


def _leaves(state):
    out = {}
    for name, comp in state.items():
        items = (dataclasses.asdict(comp).items()
                 if dataclasses.is_dataclass(comp) else comp.items())
        for k, v in items:
            out[f"{name}/{k}"] = v
    return out


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("variant,buckets", [("apan", None), ("tgn", 8)])
def test_shard_unshard_round_trip(n, variant, buckets):
    cfg = tmdgnn.MDGNNConfig(variant=variant, n_nodes=29, d_edge=3, d_mem=4,
                             d_msg=4, d_embed=4, n_neighbors=3,
                             mailbox_size=3, pres_buckets=buckets,
                             n_shards=n)
    state = _random_state(cfg, n)
    sharded = trouting.shard_state(cfg, state, trouting.get_mesh(n, "cpu"))
    assert trouting.is_sharded(sharded)
    back = trouting.unshard_state(cfg, sharded)
    want, got = _leaves(state), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # the shards' real rows, concatenated, are JAX's permuted layout; a
    # shard of a dump-row component carries the global dump row
    for k, shards in _leaves(sharded).items():
        name = k.split("/")[0]
        rows = buckets if name == "pres" and buckets else cfg.n_nodes
        per = trouting.rows_per_shard(rows, n)
        real = torch.cat([x[:per] for x in shards]).numpy()
        np.testing.assert_array_equal(
            real, jrouting.to_shard_layout(want[k][:rows].numpy(), rows, n))
        if want[k].shape[0] == rows + 1:
            for x in shards:
                assert torch.equal(x[per:], want[k][rows:])


def test_get_mesh(monkeypatch):
    assert trouting.get_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="n_shards"):
        trouting.get_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only 2 CUDA device"):
        trouting.get_mesh(4, "cuda")
    with pytest.raises(ValueError, match="only 2 CUDA device"):
        trouting.get_mesh(4)
    assert trouting.get_mesh(2, "cuda") == (torch.device("cuda", 0),
                                            torch.device("cuda", 1))
    assert trouting.get_mesh(4, "cuda:1") == (torch.device("cuda", 1),) * 4


def test_natural_state_needs_sharding(tiny_stream):
    """n_shards > 1 never runs the single-device path on a natural
    state."""
    cfg, jp, _ = _setup(tiny_stream, n_shards=2)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError, match="shard_state"):
        tloop.memory_and_pres(tp, cfg, tmdgnn.init_state(cfg, "cpu"),
                              _tbatch(tiny_stream))


# ---------------------------------------------------------------------------
# the sharded memory stage
# ---------------------------------------------------------------------------


def _jcfg(stream, **kw):
    base = dict(variant="tgn", n_nodes=stream.num_nodes,
                d_edge=stream.feat_dim, d_mem=16, d_msg=16, d_time=8,
                d_embed=16, n_neighbors=4, use_pres=True, use_kernels=True)
    base.update(kw)
    return jmdgnn.MDGNNConfig(**base)


def _setup(stream, **kw):
    """(port cfg, JAX params, a drawn natural state as numpy)."""
    jcfg = _jcfg(stream, **kw)
    jp, _ = jmdgnn.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    n, d = jcfg.n_nodes, jcfg.d_mem
    rows = jcfg.pres_buckets or n
    counts = rng.integers(0, 4, (rows, 2)).astype(np.float32)
    xi = (rng.normal(size=(rows, 2, d)) * counts[..., None]).astype(
        np.float32)
    st = {"memory": {"mem": rng.normal(size=(n, d)).astype(np.float32),
                     "last_update": rng.uniform(0, 5, n).astype(np.float32)},
          "neighbors": {"nbr": np.full((n, 4), -1, np.int32),
                        "t": np.zeros((n, 4), np.float32),
                        "ptr": np.zeros(n, np.int32)},
          "pres": {"n": counts, "xi": xi,
                   "psi": (xi ** 2 + counts[..., None]).astype(np.float32)}}
    return tmdgnn.MDGNNConfig(**dataclasses.asdict(jcfg)), jp, st


def _jstate(st):
    return {"memory": JMem(mem=jnp.asarray(st["memory"]["mem"]),
                           last_update=jnp.asarray(
                               st["memory"]["last_update"])),
            "neighbors": {k: jnp.asarray(v)
                          for k, v in st["neighbors"].items()},
            "pres": JPres(**{k: jnp.asarray(v)
                             for k, v in st["pres"].items()})}


def _batch(stream):
    """The stream's second batch of 100, its last 7 events masked."""
    b = stream.temporal_batches(100)[1]
    mask = np.asarray(b.mask).copy()
    mask[-7:] = False
    return dataclasses.replace(b, mask=jnp.asarray(mask))


def _tbatch(stream):
    b = _batch(stream)
    return tevents.EventBatch.from_numpy(
        np.asarray(b.src), np.asarray(b.dst), np.asarray(b.t),
        np.asarray(b.feat), np.asarray(b.mask), "cpu")


def _port_stage(cfg, jp, st, stream, n):
    cfg = dataclasses.replace(cfg, n_shards=n)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    state = trouting.shard_state(cfg, bridge.state_from_numpy(st, "cpu"),
                                 trouting.get_mesh(n, "cpu"))
    with torch.no_grad():
        mem, info, fused, delta = trouting.sharded_memory_and_pres(
            tp, cfg, state, _tbatch(stream))
    nat = trouting.unshard_state(cfg, dict(state, memory=mem))["memory"]
    return nat, info, fused, delta


def _compare(nat, info, fused, delta, j_mem, j_info, j_fused, j_delta):
    np.testing.assert_allclose(nat.mem.numpy(), _np(j_mem.mem), atol=ATOL)
    np.testing.assert_array_equal(nat.last_update.numpy(),
                                  _np(j_mem.last_update))
    mask = _np(j_info["mask"])
    np.testing.assert_array_equal(info["selected"].numpy(),
                                  _np(j_info["selected"]))
    for got, want in ((fused, j_fused), (delta, j_delta),
                      (info["s_meas"], j_info["s_meas"]),
                      (info["msgs"], j_info["msgs"])):
        np.testing.assert_allclose(got.numpy()[mask], _np(want)[mask],
                                   atol=ATOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_single_shard_protocol_matches_jax(tiny_stream, use_kernels):
    """n_shards = 1 runs every phase with degenerate collectives, in both
    packages (JAX on its one-device mesh, in process)."""
    cfg, jp, st = _setup(tiny_stream, use_kernels=use_kernels, n_shards=1)
    jcfg = _jcfg(tiny_stream, use_kernels=use_kernels, n_shards=1)
    jb = _batch(tiny_stream)
    j_mem, j_info, j_fused, j_delta = jax.jit(
        lambda p, s: jrouting.sharded_memory_and_pres(p, jcfg, s, jb))(
            jp, _jstate(st))
    nat, info, fused, delta = _port_stage(cfg, jp, st, tiny_stream, 1)
    _compare(nat, info, fused, delta, j_mem, j_info, j_fused, j_delta)
    assert int(info["route_overflow"]) == int(j_info["route_overflow"]) == 0


CASES = {
    "gru": {},
    "plain": dict(use_kernels=False),
    "rnn": dict(memory_cell="rnn"),
    "alg1": dict(use_pres=False),
    "mean": dict(aggregator="mean"),
    "time": dict(pres_scale="time", delta_mode="innovation"),
    "buckets": dict(pres_buckets=8),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_stage_matches_single_device_jax(tiny_stream, n, case):
    cfg, jp, st = _setup(tiny_stream, **CASES[case])
    jcfg = _jcfg(tiny_stream, **CASES[case])
    jb = _batch(tiny_stream)
    j_mem, j_info, j_fused, j_delta = jax.jit(
        lambda p, s: jloop.memory_and_pres(p, jcfg, s, jb))(jp, _jstate(st))
    nat, info, fused, delta = _port_stage(cfg, jp, st, tiny_stream, n)
    _compare(nat, info, fused, delta, j_mem, j_info, j_fused, j_delta)
    assert int(info["route_overflow"]) == 0
    assert info["route_overflow_shards"].tolist() == [0] * n


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tight_budget_overflow_matches_jax(tiny_stream, n):
    """A budget below the lane load: the masked rows are counted, and the
    count is JAX's plan of the same occurrences (JAX's whole protocol at
    n_shards = 1)."""
    budget = 3
    cfg, jp, st = _setup(tiny_stream, n_shards=n, shard_budget=budget)
    nodes, _, _, _, mask, _, _ = jrouting._padded_occurrences(
        _batch(tiny_stream), n)
    ms = nodes.shape[0] // n
    want = [int(jrouting.bucket_plan(
        jnp.clip(nodes[s * ms:(s + 1) * ms], 0, cfg.n_nodes - 1) % n,
        mask[s * ms:(s + 1) * ms], n, budget)[3]) for s in range(n)]
    if n == 1:
        jcfg = _jcfg(tiny_stream, n_shards=1, shard_budget=budget)
        jb = _batch(tiny_stream)
        _, j_info, _, _ = jax.jit(
            lambda p, s: jrouting.sharded_memory_and_pres(p, jcfg, s, jb))(
                jp, _jstate(st))
        assert int(j_info["route_overflow"]) == sum(want)
    _, info, fused, _ = _port_stage(cfg, jp, st, tiny_stream, n)
    assert info["route_overflow_shards"].tolist() == want
    assert int(info["route_overflow"]) == sum(want) > 0
    assert torch.isfinite(fused).all()
