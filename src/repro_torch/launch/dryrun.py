"""Dry run of every (arch x input shape x production mesh) pair
(counterpart of `repro/launch/dryrun.py`).

    python -m repro_torch.launch.dryrun [--arch A,B] [--shape S,T]
        [--mesh single,multi] [--out results/dryrun_torch] [--rules R]
        [--optimizer O] [--strategy gspmd|compact_update|optimized]
        [--dense-attn] [--tag T] [--skip-existing]

JAX lowers and compiles each spec for 512 fake host devices and reads
XLA's analyses. PyTorch has no such compiler: here the spec's step RUNS,
on meta-device arguments (shapes, no data), as DTensors over the
production mesh of a `FakeStore` process group of 256 or 512 ranks
(collectives move nothing). One rank's view is every rank's, so the
numbers are per device:

* collectives: every collective the step issues, read from
  `train/distributed.py::collective_log` (not from HLO), with JAX's
  per-kind `count` / `bytes` (the result's bytes x `WIRE_FACTOR`) and
  `total_bytes`. The step runs each collective once per execution, so
  the scan-over-layers trip count (`scan_trip`) is recorded and not
  multiplied in, where JAX multiplies its loop bodies' collectives;
* flops_per_device: each op's FLOPs as `FlopCounterMode` counts them on
  the op's global shapes, scaled to this rank's share: the local
  fraction of the op's first output, divided by the ranks of each mesh
  dim on which the output is a partial sum (its contraction split);
* bytes_per_device: every op's local operand and result bytes, unfused
  (XLA's post-fusion "bytes accessed" has no counterpart; this is an
  upper estimate);
* memory_analysis: the arguments' and results' bytes per device from
  their local shard shapes; "temp_bytes" and "generated_code_bytes" are
  null (no compiled program: its buffer assignment and code size do not
  exist), and so is "compile_s".

The roofline terms divide by the H100 SXM figures of `launch/mesh.py`:
compute by its dense bf16 peak, memory by its HBM rate, and each
collective by NVLink's rate where its mesh dim lies in one 8-card node
(ranks in mesh order, the last dim innermost), by the inter-node rate
otherwise (every axis of the production meshes spans nodes). They are
estimates from data-sheet figures, not measurements.
A pair that fails is written with status "error" and the message.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.nn import module as module_lib
from repro_torch.train import annotate
from repro_torch.train import distributed as tdist

# bytes-on-the-wire factor per collective kind (ring algorithms): an
# all-reduce moves about twice its buffer, the others about once
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
# functional collective (by name prefix) -> JAX's HLO kind
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "broadcast": "collective-permute"}


def _kind(name: str) -> str:
    for prefix, kind in _KINDS.items():
        if name.startswith(prefix):
            return kind
    raise ValueError(f"unknown collective {name!r}")


def _result_bytes(c) -> int:
    return math.prod(c.out_shape) * c.dtype.itemsize


def collective_stats(log) -> dict:
    """Per-device collective counts and bytes from a `collective_log` (or
    its list of `Collective`s): {kind: {"count", "bytes"}, ...,
    "total_bytes"}, each collective's result bytes times its kind's
    WIRE_FACTOR, as JAX's HLO parser counts a line's result."""
    records = getattr(log, "shapes", log)
    stats = {k: {"count": 0, "bytes": 0.0} for k in WIRE_FACTOR}
    for c in records:
        kind = _kind(c.name)
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += _result_bytes(c) * WIRE_FACTOR[kind]
    stats["total_bytes"] = sum(v["bytes"] for v in stats.values()
                               if isinstance(v, dict))
    return stats


def collective_seconds(log, group_spans: dict) -> float:
    """The collectives' time at data-sheet rates: each one's wire bytes
    over NVLink's rate where its group lies in one node, over the
    inter-node rate otherwise. `group_spans`: group name -> the ranks its
    mesh dim spans in rank order (its size times the sizes of the dims
    inside it); a span of at most `NODE_SIZE` lies in one node, and an
    unknown group counts as spanning nodes."""
    total = 0.0
    for c in getattr(log, "shapes", log):
        wire = _result_bytes(c) * WIRE_FACTOR[_kind(c.name)]
        in_node = group_spans.get(c.group, math.inf) <= mesh_lib.NODE_SIZE
        total += wire / (mesh_lib.NVLINK_BW if in_node
                         else mesh_lib.INTER_NODE_BW)
    return total


def scan_trip_count(cfg) -> int:
    """The scan-over-layers trip count of an arch (JAX's multiplier for
    its loop-body collectives; recorded here, see the module
    docstring)."""
    if type(cfg).__name__ == "MDGNNConfig":
        return 1
    if not getattr(cfg, "scan_layers", False):
        return 1
    if cfg.family == "audio":
        return max(cfg.n_layers, cfg.enc_layers)
    if cfg.family in ("dense", "vlm"):
        pattern = cfg.global_every if cfg.global_every else 1
        return cfg.n_layers // pattern
    if cfg.family == "moe":
        return cfg.n_layers - cfg.first_dense
    if cfg.family == "ssm":
        pattern = cfg.slstm_every if cfg.slstm_every else 1
        return cfg.n_layers // pattern
    if cfg.family == "hybrid":
        pattern = cfg.attn_every if cfg.attn_every else 1
        return cfg.n_layers // pattern
    return cfg.n_layers


def _shape_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _shape_leaves(v)
    else:
        yield tree


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D for a forward-only shape; D = global_batch tokens a decode
    step. The MDGNN: 6 N x the batch's events."""
    if type(cfg).__name__ == "MDGNNConfig":
        from repro_torch.models import mdgnn
        n_params = sum(math.prod(s)
                       for s in _shape_leaves(mdgnn.param_shapes(cfg)))
        return 6.0 * n_params * shape.global_batch * shape.seq_len
    n_params = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_params * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params * shape.global_batch * shape.seq_len
    return 2.0 * n_params * shape.global_batch   # one token a sequence


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def active_param_count(cfg) -> float:
    """Active parameters a token: the expert weights (paths holding
    "/moe/w") count top_k / n_experts of themselves."""
    from repro_torch.archs.api import get_model
    shapes, _ = specs_lib.abstract_init(get_model(cfg))
    total = moe_total = 0
    for path, leaf in _paths(shapes):
        if "/moe/w" in path:
            moe_total += leaf.numel()
        else:
            total += leaf.numel()
    if cfg.n_experts:
        total += moe_total * cfg.top_k / cfg.n_experts
    return float(total)


def _local(t):
    return t.to_local() if annotate.is_dtensor(t) else t


def _tensors(tree):
    out = []
    annotate.map_tensors(out.append, tree)
    return out


def _tree_bytes(tree) -> int:
    return sum(_local(t).numel() * t.element_size() for t in _tensors(tree))


class LocalCost(TorchDispatchMode):
    """Counts the FLOPs and the operand bytes of every op on this rank's
    shards (see the module docstring): `.flops`, `.bytes`."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import FlopCounterMode
        kwargs = kwargs or {}
        with FlopCounterMode(display=False) as fc:
            out = func(*args, **kwargs)
        flops = fc.get_total_flops()
        if flops:
            first = next(iter(_tensors(out)), None)
            if annotate.is_dtensor(first) and first.numel():
                from torch.distributed.tensor import Partial
                share = _local(first).numel() / first.numel()
                for i, p in enumerate(first.placements):
                    if isinstance(p, Partial):
                        share /= first.device_mesh.size(i)
                flops *= share
            self.flops += flops
        self.bytes += _tree_bytes((args, kwargs, out))
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """A FakeStore process group of `world` ranks (this process rank 0)
    for the block, unless one of that size is already up."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is up; the mesh needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_name(mesh_shape) -> str:
    return "x".join(str(n) for n in mesh_shape)


def run_pair(arch_id: str, shape_name: str, multi_pod: bool,
             rules: str | None = None, optimizer: str | None = None,
             strategy: str = "gspmd", dense_attn: bool = False,
             cfg=None, mesh_shape=None) -> dict:
    """The dry run of one pair on the (16, 16) mesh, or (2, 16, 16) with
    `multi_pod`; `cfg` replaces the arch's config (a reduced one in
    tests) and `mesh_shape` the production mesh (a ("data", "model") or
    ("pod", "data", "model") shape)."""
    shape = SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (mesh_lib.MULTI_POD_SHAPE if multi_pod
                      else mesh_lib.PRODUCTION_SHAPE)
    rule_dict = None if rules is None else dict(module_lib.RULE_SETS[rules])
    with fake_group(math.prod(mesh_shape)):
        if len(mesh_shape) == 3:
            mesh = mesh_lib.make_debug_mesh(*mesh_shape[1:],
                                            pod=mesh_shape[0],
                                            device_type="cpu")
        else:
            mesh = mesh_lib.make_debug_mesh(*mesh_shape, device_type="cpu")
        if arch_id == "tgn-pres":
            # the paper's own workload: a temporal batch of global_batch x
            # seq_len events against the production-size memory table, on
            # the port's kernel route (the fused memory_update_table pass,
            # its plain version on meta)
            from repro_torch.configs.tgn_pres import PRODUCTION
            cfg = cfg or dataclasses.replace(PRODUCTION, use_kernels=True)
            if strategy == "optimized":
                # replicated parameters and state, event parallelism over
                # every mesh axis, bucketed trackers, a bf16 table
                cfg = dataclasses.replace(cfg, pres_buckets=65536,
                                          mem_dtype="bfloat16")
                rule_dict = rule_dict or dict(
                    module_lib.RULE_SETS["mdgnn_event_dp_repl"])
            spec = tdist.make_mdgnn_train_spec(
                cfg, shape.global_batch * shape.seq_len, mesh,
                rules=rule_dict, strategy=strategy)
        else:
            cfg = cfg or get_config(arch_id)
            if dense_attn:   # the dense-attention baseline
                cfg = dataclasses.replace(cfg, attn_chunk=None)
            spec = specs_lib.make_spec(cfg, shape, mesh, rules=rule_dict,
                                       optimizer=optimizer)
        args = spec.args
        if shape.kind == "decode" and arch_id != "tgn-pres":
            args = args[:3] + (0,)          # the position, on the host
        group_spans = {mesh.get_group(i).group_name:
                       math.prod(mesh.shape[i:]) for i in range(mesh.ndim)}
        t0 = time.perf_counter()
        with torch.no_grad() if shape.kind != "train" else \
                contextlib.nullcontext(), \
                tdist.collective_log() as log, LocalCost() as cost:
            out = tdist.apply_spec(spec, mesh, *args)
        run_s = time.perf_counter() - t0
        mem_info = {
            "argument_bytes": sum(_tree_bytes(tdist.distribute_tree(
                a, s, mesh)) for a, s in zip(args, spec.in_shardings)),
            "output_bytes": _tree_bytes(out),
            "temp_bytes": None,
            "generated_code_bytes": None,
        }
        chips = mesh.size()
        coll = collective_stats(log)
        coll_s = collective_seconds(log, group_spans)
    trip = scan_trip_count(cfg)
    mf = model_flops(cfg, shape)
    result = {
        "arch": arch_id, "shape": shape_name,
        "mesh": _mesh_name(mesh_shape), "chips": chips,
        "run_s": round(run_s, 2), "compile_s": None,
        "flops_per_device": cost.flops,
        "bytes_per_device": float(cost.bytes),
        "collective_bytes_per_device": coll["total_bytes"],
        "scan_trip": trip,
        "collectives": {k: v for k, v in coll.items() if isinstance(v, dict)},
        "memory_analysis": mem_info,
        "model_flops_global": mf,
        "status": "ok",
    }
    # roofline terms (seconds), per device; the analytic MODEL_FLOPS floor
    # (6ND / 2ND a chip) beside the counted FLOPs, as in JAX
    result["compute_counted_s"] = cost.flops / mesh_lib.PEAK_FLOPS_BF16
    result["compute_model_s"] = (mf / chips) / mesh_lib.PEAK_FLOPS_BF16
    result["compute_s"] = max(result["compute_counted_s"],
                              result["compute_model_s"])
    result["memory_s"] = cost.bytes / mesh_lib.HBM_BW
    result["collective_s"] = coll_s
    terms = {"compute": result["compute_s"], "memory": result["memory_s"],
             "collective": result["collective_s"]}
    result["bottleneck"] = max(terms, key=terms.get)
    result["useful_flops_ratio"] = ((mf / chips) / cost.flops
                                    if cost.flops else None)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta "
                                 "tensors over a fake process group")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--rules", default=None,
                    help="override the logical -> mesh rule set")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--strategy", default="gspmd",
                    help="MDGNN distribution strategy: gspmd | "
                         "compact_update | optimized")
    ap.add_argument("--dense-attn", action="store_true",
                    help="disable blockwise attention (dense baseline)")
    ap.add_argument("--tag", default=None, help="suffix for result filenames")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"-{args.tag}" if args.tag else ""
                name = f"{arch}__{shape}__{mesh_kind}{tag}.json"
                path = outdir / name
                if args.skip_existing and path.exists():
                    print(f"[skip existing] {name}")
                    continue
                if not shape_applicable(arch, shape):
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "status": "skipped",
                        "reason": "long_500k requires sub-quadratic "
                                  "attention"}, indent=2))
                    print(f"[skip n/a] {name}")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...",
                      flush=True)
                try:
                    res = run_pair(arch, shape, mesh_kind == "multi",
                                   rules=args.rules,
                                   optimizer=args.optimizer,
                                   strategy=args.strategy,
                                   dense_attn=args.dense_attn)
                except Exception as e:   # recorded per pair, as JAX's
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                path.write_text(json.dumps(res, indent=2))
                extra = ""
                if res["status"] == "ok":
                    extra = (f" run={res['run_s']}s "
                             f"bottleneck={res['bottleneck']} "
                             f"C={res['compute_s']:.4f}s "
                             f"M={res['memory_s']:.4f}s "
                             f"X={res['collective_s']:.4f}s")
                print(f"[done] {name}: {res['status']}{extra}", flush=True)


if __name__ == "__main__":
    main()
