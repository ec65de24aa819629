"""The work counts against sizes worked by hand, and the logical sizes
the harness rebuilds (rings, the deduplicated frontier)."""
from __future__ import annotations

import pytest
import torch

from chipbench import bench
from chipbench.work import frontier


def test_memory_update_table_by_hand():
    s = {"occ": 4, "rows_written": 3, "d_msg": 2, "d_mem": 1}
    flops, nbytes = bench.work("memory_update_table", s)
    assert flops == 2 * 4 * 3 * 3 + 16 * 4
    # x 8, rows 3, dmean 4, four per-occurrence words 16, weights 6 + 3 + 3
    # read; s_meas, fused, delta 12, rows 3, times 3 written
    assert nbytes == 4 * (8 + 3 + 4 + 16 + 12) + 4 * (12 + 3 + 3)


def test_gru_cell_by_hand():
    assert bench.work("gru_cell", {"occ": 2, "d_msg": 3, "d_mem": 2}) == (
        2 * 2 * 5 * 6 + 10 * 2 * 2, 4 * (6 + 4 + 18 + 12 + 6) + 4 * 4)


def test_embed_attn_by_hand():
    s = {"rows": 2, "valid_slots": 3, "child_rows": 4, "ds": 2, "din": 2,
         "dtime": 1, "e": 2, "heads": 2, "k": 2}
    f, b = bench.work("embed_attn", s)
    assert f == 2 * 2 * 2 * 2 + 4 * 2 * 3 * 2 + 4 * 2 * 3 * 3 + 3 * 1
    assert b == 4 * (4 + 8 + 2 + 4 + 12) + 9 * 4 + 4 * 4


def test_train_step_is_three_forwards():
    call = {"rows": 2, "valid_slots": 3, "child_rows": 4, "ds": 2, "din": 2,
            "dtime": 1, "e": 2, "heads": 2, "k": 2}
    s = {"occ": 4, "d_mem": 2, "d_msg": 2, "d_time": 1, "d_edge": 1,
         "d_embed": 2, "attn": [call], "pairs": 3}
    fwd = (2 * 4 * (6 * 2 + 4) + 2 * 4 * 4 * 6
           + bench.work("embed_attn", call)[0] + 2 * 2 * 4 * 2
           + 2 * 3 * (8 + 2))
    assert bench.work("train_step", s) == (3 * fwd, 0.0)


def test_rings_and_the_deduplicated_frontier():
    cfg = {"n_nodes": 6, "n_neighbors": 2, "n_layers": 2, "d_mem": 4,
           "d_embed": 4, "d_time": 2, "n_heads": 2}
    r = frontier.Rings(cfg, "cpu")
    f = lambda *a: torch.tensor(a)
    # events (0,3,t1), (1,3,t2), (0,4,t3): node 3 holds 0@1, 1@2; node 0
    # holds 3@1, 4@3; node 4 holds 0@3; node 1 holds 3@2
    r.append(f(0, 1, 0), f(3, 3, 4), f(1.0, 2.0, 3.0), f(True, True, True))
    assert r.st.nbr[3].tolist() == [0, 1] and r.st.nbr[0].tolist() == [3, 4]
    calls = r.attention_calls(f(0, 0, 5), f(9.0, 9.0, 9.0),
                              f(True, True, True))
    # hop 0: rows {0@9, 5@9}, 2 valid slots (node 0's); hop 1: {3@1,
    # 4@3}, 3 valid slots; hop 2: {0@1, 1@2, 0@3}
    assert [(c["rows"], c["valid_slots"], c["child_rows"]) for c in calls] \
        == [(2, 2, 2), (2, 3, 3), (2, 2, 2)]
    assert calls[2]["ds"] == 4 and calls[0]["din"] == 4


def test_ring_keeps_the_last_k():
    cfg = {"n_nodes": 3, "n_neighbors": 2, "n_layers": 1, "d_mem": 1,
           "d_embed": 1, "d_time": 1, "n_heads": 1}
    r = frontier.Rings(cfg, "cpu")
    f = lambda *a: torch.tensor(a)
    r.append(f(0, 0, 0), f(1, 2, 1), f(1.0, 2.0, 3.0), f(True, True, True))
    assert sorted(zip(r.st.nbr[0].tolist(), r.st.nbr_t[0].tolist())) == [
        (1, 3.0), (2, 2.0)]
    assert int(r.st.fill[0]) == 1


@pytest.mark.parametrize("q,want", [(50, 2.5), (95, 4.75), (0, 0.0)])
def test_percentile(q, want):
    assert bench.percentile([3, 0, 1, 5, 2, 4], q) == pytest.approx(want)
