"""The memory-table write of the cell routes on the CPU:
`batching.write_selected`, through which `mdgnn.memory_update`,
`loop._apply_pres` and `ref.memory_update_table_ref` write each node's
selected row and time.

The write is one `index_put_` of fixed shape over all 2b occurrences, so
it waits for nothing on the host. It replaced a write at the selected
positions that `torch.nonzero` found (a data-dependent length: one host
sync a step). That write is kept here (`_nonzero_write`) as the
reference, and the new one is held to it bit for bit: the memory table
(fp32 and bf16), `last_update`, the memory stage's outputs and every
parameter gradient, on batches where every node repeats (8 nodes, b 50),
with masked events (one node masked only) and fully masked. One train
step's parameter gradients on such a batch are held against the JAX
package's at the tolerances of `test_torch_filter.py::
test_train_steps_match_jax` (the first moments after one step, 0.1 x the
gradients: each leaf within 1e-5 of the largest moment of the tree and
within 1e-2 of its own; table 1e-5; last_update and rings exact)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (threads under xdist)

import jax

from repro.graph.events import EventBatch as JEventBatch
from repro.models import mdgnn as jmdgnn
from repro.models.modules import MemoryState as JMemoryState
from repro.optim import optimizers as joptim

from repro_torch import bridge
from repro_torch.core import batching
from repro_torch.graph.events import EventBatch
from repro_torch.kernels import ref
from repro_torch.models import mdgnn as tmdgnn
from repro_torch.models.modules import MemoryState
from repro_torch.train import loop as tloop
from repro_torch.utils.tree import tree_leaves

from test_torch_filter import (_assert_moments, _assert_state, _assert_tree,
                               _jax_step, _jstate_np, _setup, _tbatch)

N, B, D_EDGE = 8, 50, 4


def _nonzero_write(table, rows, keep, values):
    """The write `write_selected` replaced: the kept positions by
    `torch.nonzero`, then table[rows[kept]] = values[kept]."""
    k = torch.nonzero(keep)[:, 0]
    table[rows.index_select(0, k)] = values.index_select(0, k).to(table.dtype)
    return table


def _events(seed, case, t0=0.0):
    """b events over 8 nodes (sources 0-3, destinations 4-7: every node
    about 12 times). "masked": every third event masked, and node 7 only
    in masked events; "all-masked": every event masked."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 4, B).astype(np.int32)
    dst = rng.integers(4, 7, B).astype(np.int32)
    mask = np.ones(B, bool)
    if case == "masked":
        mask[::3] = False
        dst[::6] = 7
    elif case == "all-masked":
        mask[:] = False
    t = (t0 + np.sort(rng.random(B)) * 10).astype(np.float32)
    t[5] = t[6]                                     # a tie in time
    feat = rng.normal(size=(B, D_EDGE)).astype(np.float32)
    return src, dst, t, feat, mask


ROUTES = {
    "alg1": dict(use_pres=False, use_kernels=True),
    "rnn-pres": dict(memory_cell="rnn", use_pres=True, use_kernels=True),
    "rnn-std": dict(memory_cell="rnn", use_pres=False, use_kernels=True),
    "plain": dict(use_pres=True, use_kernels=False),
}
CASES = ("repeat", "masked", "all-masked")


def _tcfg(route, **kw):
    return tmdgnn.MDGNNConfig(variant="tgn", n_nodes=N, d_edge=D_EDGE,
                              d_mem=8, d_msg=8, d_time=4, d_embed=8,
                              n_neighbors=4, **ROUTES[route], **kw)


def _state(cfg, seed=3):
    """init_state with a drawn memory table and last-update times."""
    rng = np.random.default_rng(seed)
    state = tmdgnn.init_state(cfg, "cpu")
    mem = torch.as_tensor(rng.normal(size=(N, cfg.d_mem)).astype(np.float32))
    state["memory"] = MemoryState(
        mem=mem.to(getattr(torch, cfg.mem_dtype)),
        last_update=torch.as_tensor(rng.random(N).astype(np.float32)))
    return state


def _memory_stage(cfg, params, state, batch):
    """memory_and_pres with autograd on, and the parameter gradients of a
    drawn linear read of the written table and the stage's outputs."""
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    mem, info, fused, delta = tloop.memory_and_pres(params, cfg, state, batch)
    g = torch.Generator().manual_seed(5)
    w_tab = torch.randn(mem.mem.shape, generator=g)
    w_out = torch.randn(fused.shape, generator=g)
    loss = (mem.mem.float() * w_tab).sum() + (fused * w_out).sum() + \
        (delta * w_out).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return mem, fused.detach(), delta.detach(), grads


@pytest.mark.parametrize("route", ["alg1", "rnn-pres", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_write_matches_the_nonzero_write(monkeypatch, case, dtype, route):
    """The memory stage through `write_selected` against the same stage
    through the nonzero write it replaced: table, last_update, fused rows,
    deltas and every parameter gradient bit for bit."""
    cfg = _tcfg(route, mem_dtype=dtype)
    batch = EventBatch.from_numpy(*_events(0, case), "cpu")
    params = tmdgnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = _memory_stage(cfg, params, _state(cfg), batch)
    with monkeypatch.context() as m:
        m.setattr(batching, "write_selected", _nonzero_write)
        want = _memory_stage(cfg, params, _state(cfg), batch)
    before = _state(cfg)["memory"]
    assert got[0].mem.shape == (N, cfg.d_mem)
    assert got[0].mem.dtype == getattr(torch, dtype)
    assert torch.equal(got[0].mem, want[0].mem)
    assert torch.equal(got[0].last_update, want[0].last_update)
    for a, b in zip(got[1:3], want[1:3]):
        assert torch.equal(a, b)
    for a, b in zip(got[3], want[3]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    changed = (got[0].last_update != before.last_update).any()
    assert bool(changed) == (case != "all-masked")
    if case == "all-masked":
        assert torch.equal(got[0].mem, before.mem)
    if case == "masked":                  # node 7: masked occurrences only
        assert torch.equal(got[0].mem[7], before.mem[7])
        assert got[0].last_update[7] == before.last_update[7]


def _table_inputs(case, dtype, m=64, n=N, d=8, din=6, seed=7):
    """memory_update_table_ref's inputs: occurrences over n rows, the
    selected one of each node written, the rest sent to n (dropped);
    "masked": a third of the occurrences read the zero row (gather index
    n + 1) and write nothing; "all-masked": nothing written."""
    rng = np.random.default_rng(seed)
    nodes = torch.as_tensor(rng.integers(0, n, m))
    times = torch.as_tensor(np.sort(rng.random(m)).astype(np.float32))
    mask = torch.ones(m, dtype=torch.bool)
    if case == "masked":
        mask[::3] = False
    elif case == "all-masked":
        mask[:] = False
    order = tmdgnn.occurrence_order(nodes, times, mask)
    sel = tmdgnn._last_occurrence_flags(nodes, times, mask)
    gidx = torch.where(mask, nodes, torch.full_like(nodes, n + 1))[order]
    widx = torch.where(sel, nodes, torch.full_like(nodes, n))[order]
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    table = f(n, d).to(getattr(torch, dtype))
    return (table, torch.as_tensor(rng.random(n).astype(np.float32)),
            f(m, din), gidx.int(), widx.int(), times[order], f(din, 3 * d),
            f(d, 3 * d), f(3 * d), f(m, d), torch.rand(m) * 3,
            torch.tensor(0.3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_table_ref_matches_its_old_output(monkeypatch, case, dtype):
    """`memory_update_table_ref` (the table kernel's plain version) against
    its output with the boolean-mask write it had: every output bit for
    bit, written in place on the table and times it was given."""
    args = _table_inputs(case, dtype)
    clone = lambda a: [x.clone() for x in a]
    kw = dict(clip=1.0, delta_mode="transition")
    got_in = clone(args)
    got = ref.memory_update_table_ref(*got_in, **kw)
    with monkeypatch.context() as m:
        m.setattr(batching, "write_selected", _nonzero_write)
        want = ref.memory_update_table_ref(*clone(args), **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0] is got_in[0] and got[1] is got_in[1]      # in place
    if case == "all-masked":
        assert torch.equal(got[0], args[0])
        assert torch.equal(got[1], args[1])
    else:
        assert not torch.equal(got[0], args[0])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_step_gradients_match_jax(route):
    """One lag-one train step whose memory batch repeats every node, with
    masked events, from the state and parameters a first JAX step left
    (rings filled, memory written): the first moments (0.1 x every
    parameter's gradient), the parameters, the table, last_update and
    the rings against JAX's."""
    s = dataclasses.asdict(_tcfg(route))
    jcfg = jmdgnn.MDGNNConfig(**s)
    tcfg = tmdgnn.MDGNNConfig(**s)
    jb = [JEventBatch(*map(np.asarray, _events(seed, case, t0)))
          for seed, case, t0 in ((10, "repeat", 0.0), (11, "masked", 10.0),
                                 (12, "repeat", 20.0))]
    neg = lambda b: dataclasses.replace(b, dst=np.roll(b.dst, 7))
    (jparams, jos, jstate, _, topt, _, _) = _setup(jcfg)
    jstep = _jax_step(jcfg)
    jparams, _, jstate, _ = jstep(jparams, jos, jstate, jb[0], jb[1],
                                  neg(jb[1]))
    tparams = bridge.params_from_numpy(jax.tree.map(np.array, jparams),
                                       "cpu")
    tstate = bridge.state_from_numpy(_jstate_np(jstate), "cpu")
    assert float(np.abs(np.asarray(jstate["memory"].mem)).max()) > 0.0
    assert isinstance(jstate["memory"], JMemoryState)
    # a fresh optimizer state (the first step's was donated)
    jout = jstep(jparams, joptim.adamw(1e-3).init(jparams), jstate, jb[1],
                 jb[2], neg(jb[2]))
    tout = tloop.make_train_step(tcfg, topt)(
        tparams, topt.init(tparams), tstate, _tbatch(jb[1]), _tbatch(jb[2]),
        _tbatch(neg(jb[2])))
    assert abs(float(tout[3]["loss"]) - float(jout[3]["loss"])) <= \
        1e-5 * abs(float(jout[3]["loss"]))
    _assert_moments(tout[1]["mu"], jout[1]["mu"], 1e-5)
    _assert_tree(tout[0], jout[0], 1e-5, "param")
    _assert_state(tout[2], jout[2], 1e-5)
    assert float(tout[1]["mu"]["mem"]["w"].abs().max()) > 0.0
