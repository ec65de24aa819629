"""The port's dry run (`launch/dryrun.py`) against the JAX package's on the
CPU.

- `collective_stats` on log records gives exactly what JAX's HLO parser
  gives on the same collectives written as HLO lines (JAX
  tests/test_distributed.py:126-155).
- `scan_trip_count`, `model_flops` and `active_param_count` equal JAX's
  for qwen3-0.6b, kimi-k2 and tgn-pres at their published configs.
- `run_pair` on the reduced qwen3 x train_4k over a 2x2 fake group, and
  the CLI on tgn-pres x train_4k with the "optimized" bundle over the
  16x16 FakeStore group of 256 ranks (its memory table's shard checked
  on the spec), and on a pair that does not apply (skipped)."""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.train.distributed import Collective


def _jdryrun():
    """JAX's dryrun module; it sets XLA_FLAGS for 512 host devices when
    imported, which must not reach JAX tests that run later in this
    process."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun


# (HLO line, the same collective as the port logs it)
COLLECTIVES = [
    ("%ag = bf16[128,256]{1,0} all-gather(%x), dimensions={0}",
     Collective("all_gather_into_tensor", (8, 256), False, (128, 256),
                torch.bfloat16, "g16")),
    ("%ar = f32[1024]{0} all-reduce(%y), to_apply=%add",
     Collective("all_reduce", (1024,), True, (1024,), torch.float32, "g16")),
    ("%rs = f32[64,64]{1,0} reduce-scatter(%z), dimensions={0}",
     Collective("reduce_scatter_tensor", (1024, 64), True, (64, 64),
                torch.float32, "g16")),
    ("%cp = bf16[32]{0} collective-permute(%w)",
     Collective("broadcast", (32,), False, (32,), torch.bfloat16, "g2")),
    ("%a2a = f32[16,16]{1,0} all-to-all(%v), dimensions={1}",
     Collective("all_to_all_single", (16, 16), False, (16, 16),
                torch.float32, "g2")),
    ("%ag2 = s32[3,5]{1,0} all-gather(%u), dimensions={0}",
     Collective("all_gather_into_tensor", (1, 5), False, (3, 5),
                torch.int32, "g2")),
]


def test_collective_stats_match_jax_parser():
    hlo = "\n".join([line for line, _ in COLLECTIVES]
                    + ["%nothing = f32[8]{0} add(%a, %b)",
                       "%d = f32[8]{0} all-gather-done(%s)"])
    want = _jdryrun().collective_stats(hlo)
    got = dryrun.collective_stats([c for _, c in COLLECTIVES])
    assert got == want
    assert dryrun.WIRE_FACTOR == _jdryrun().WIRE_FACTOR
    # NVLink inside a node of 8, the inter-node rate across nodes
    spans = {"g2": 2, "g16": 16}
    secs = dryrun.collective_seconds([c for _, c in COLLECTIVES], spans)
    wire = {c.group: 0.0 for _, c in COLLECTIVES}
    for _, c in COLLECTIVES:
        wire[c.group] += (math.prod(c.out_shape) * c.dtype.itemsize
                          * dryrun.WIRE_FACTOR[dryrun._kind(c.name)])
    assert secs == pytest.approx(wire["g2"] / 900e9 + wire["g16"] / 50e9)
    with pytest.raises(ValueError, match="unknown collective"):
        dryrun.collective_stats([Collective("send", (1,), False, (1,),
                                            torch.float32, "g")])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "kimi-k2-1t-a32b",
                                  "tgn-pres"])
def test_trip_count_and_flops_match_jax(arch, monkeypatch):
    jd = _jdryrun()
    # JAX's model_flops traces the config's init once a shape (kimi-k2's
    # takes seconds): the same counts, traced once
    monkeypatch.setattr(jd, "active_param_count",
                        functools.lru_cache()(jd.active_param_count))
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch == "tgn-pres":
        from repro.configs.tgn_pres import PRODUCTION as JPRODUCTION
        from repro_torch.configs.tgn_pres import PRODUCTION
        jcfg, cfg = JPRODUCTION, PRODUCTION
    else:
        assert dryrun.active_param_count(cfg) == jd.active_param_count(jcfg)
    assert dryrun.scan_trip_count(cfg) == jd.scan_trip_count(jcfg)
    for name in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[name]) == jd.model_flops(
            jcfg, JSHAPES[name]), name
    if arch == "kimi-k2-1t-a32b":
        assert dryrun.active_param_count(cfg) < 60e9   # ~32B, not ~1T


def test_run_pair_reduced_qwen3_on_2x2():
    res = dryrun.run_pair("qwen3-0.6b", "train_4k", False,
                          cfg=get_config("qwen3-0.6b").reduced(
                              scan_layers=True),
                          mesh_shape=(2, 2))
    assert res["status"] == "ok" and res["mesh"] == "2x2"
    assert res["chips"] == 4 and res["scan_trip"] == 2
    assert res["collective_bytes_per_device"] > 0
    assert res["collectives"]["all-gather"]["count"] > 0
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["memory_analysis"]["temp_bytes"] is None
    assert res["memory_analysis"]["argument_bytes"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    # the 2x2 mesh's axes fit in one node: NVLink's rate
    assert res["collective_s"] == pytest.approx(
        res["collective_bytes_per_device"] / 900e9)


def test_tgn_pres_optimized_table_shard_on_16x16():
    """The optimized bundle's memory table on the 16x16 mesh: bf16 and
    replicated ("mdgnn_event_dp_repl": every device holds the 1,048,576
    rows), the events split 256 ways."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.tgn_pres import PRODUCTION
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.nn import module as tmodule
    from repro_torch.train import distributed as tdist
    cfg = dataclasses.replace(PRODUCTION, pres_buckets=65536,
                              mem_dtype="bfloat16", use_kernels=True)
    with dryrun.fake_group(256):
        mesh = mesh_lib.make_production_mesh(device_type="cpu")
        spec = tdist.make_mdgnn_train_spec(
            cfg, 256 * 4096, mesh,
            rules=dict(tmodule.RULE_SETS["mdgnn_event_dp_repl"]),
            strategy="optimized")
        table, pl = spec.args[2]["memory"].mem, spec.in_shardings[2][
            "memory"].mem
        local = distribute_tensor(table, mesh, list(pl),
                                  src_data_rank=None).to_local()
        assert tuple(local.shape) == (1_048_576, 128)
        assert local.dtype == torch.bfloat16
        ev = spec.args[3].src
        ev_pl = list(spec.in_shardings[3].src)
        assert tuple(distribute_tensor(ev, mesh, ev_pl, src_data_rank=None)
                     .to_local().shape) == (4096,)


def test_cli_writes_one_json_a_pair(tmp_path):
    dryrun.main(["--arch", "tgn-pres", "--shape", "train_4k", "--mesh",
                 "single", "--strategy", "optimized", "--out",
                 str(tmp_path)])
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--mesh",
                 "single", "--out", str(tmp_path)])
    res = json.loads((tmp_path / "tgn-pres__train_4k__single.json")
                     .read_text())
    assert res["status"] == "ok", res.get("traceback")
    assert res["mesh"] == "16x16" and res["chips"] == 256
    assert res["collective_bytes_per_device"] > 0
    assert math.isfinite(res[f"{res['bottleneck']}_s"])
    assert res["model_flops_global"] > 0
    skipped = json.loads((tmp_path / "qwen3-0.6b__long_500k__single.json")
                         .read_text())
    assert skipped["status"] == "skipped"
