"""Training cells: the train CLI's captured path,
`repro_torch.train.pipeline.run_epoch` driving
`pipeline.make_train_step(cfg, adamw(lr))` over temporal batches made from
the seed, epochs back to back with the state carried over.

Set-up makes the events, the weights and the step, and drives that step
through its first three steps (`run_epoch` over batches 0..3): the graph is
captured there, and those steps are what the reference checks. The
window then runs whole epochs from batch 0 until `--seconds` have passed
(the epoch in progress stops at the first batch past the deadline and
ends as every epoch does, with its AP over the logits); its rate counts
every scored event of every step and all the time from the first step to
the sync after the last."""
from __future__ import annotations

import numpy as np
import torch

from chipbench import bench
from chipbench.reference import mdgnn as ref
from chipbench.reference import metrics as ref_metrics
from chipbench.reference import train as ref_train
from chipbench.traffic import stream
from chipbench.work import frontier

CHECK_STEPS = 3


def mix(seed: int, k: int) -> int:
    return (seed * 1_000_003 + k) % (1 << 63)


class Feed:
    """Batches `start`.. of a list for `run_epoch`: the first two always,
    then each next one only while the deadline has not passed."""

    def __init__(self, batches, start: int, stop: int, deadline=None):
        self.batches, self.start, self.stop = batches, start, stop
        self.deadline = deadline
        self.stopped = False
        self.yielded: list = []

    def __iter__(self):
        for i in range(self.start, self.stop):
            if (len(self.yielded) >= 2 and self.deadline is not None
                    and bench.now() >= self.deadline):
                self.stopped = True
                return
            self.yielded.append(i)
            yield self.batches[i]


class TimedStep:
    """The step as `run_epoch` calls it, timed on the host (no sync) and
    inside a `chipbench.train_step` profiler range; `eager` counts the
    calls that ran eagerly on the card instead of replaying their graph
    (the step's `eager_reason`, None off CUDA)."""

    def __init__(self, step):
        self.step = step
        self.seconds: list = []
        self.eager = 0
        self.hook = None

    def __call__(self, *args):
        with torch.profiler.record_function("chipbench.train_step"):
            t0 = bench.now()
            out = self.step(*args)
            self.seconds.append(bench.now() - t0)
        if self.step.eager_reason is not None:
            self.eager += 1
        if self.hook is not None:
            self.hook(out)
        return out


class Run:
    """One cell's program side: events, batches, weights, the step."""

    def __init__(self, cell: bench.Cell, seed: int, device):
        from repro_torch.graph.events import EventBatch
        from repro_torch.models import mdgnn
        from repro_torch.optim.optimizers import adamw
        from repro_torch.train import pipeline

        self.pipeline = pipeline
        c, tr = cell.config, cell.traffic
        self.config, self.seed = c, seed
        self.use_pres = tr["use_pres"]
        self.cfg = bench.program_config(c, use_pres=self.use_pres)
        self.b = b = tr["batch"]
        n = c["epoch_events"]
        src, dst, t = stream.events(c["n_users"], c["n_items"], seed, 0, n,
                                    c["exponent"], c["noise"])
        self.nb = nb = -(-n // b)
        pad = nb * b - n
        cols = [np.concatenate([a, np.zeros(pad, a.dtype)])
                for a in (src, dst, t)]
        dev = torch.device(device)
        self.src, self.dst = (torch.as_tensor(a, device=dev).reshape(nb, b)
                              for a in cols[:2])
        self.t = torch.as_tensor(cols[2], device=dev).reshape(nb, b)
        self.mask = (torch.arange(nb * b, device=dev) < n).reshape(nb, b)
        gen = torch.Generator(device=dev).manual_seed(mix(seed, 1))
        self.feat = (stream.features(self.src.reshape(-1), c["d_edge"], gen)
                     * self.mask.reshape(-1, 1)).reshape(nb, b, -1)
        self.valid = [min(b, n - i * b) for i in range(nb)]
        self.batches = [EventBatch(self.src[i], self.dst[i], self.t[i],
                                   self.feat[i], self.mask[i])
                        for i in range(nb)]
        self.zero_feat = torch.zeros((b, c["d_edge"]), device=dev)
        self.EventBatch = EventBatch
        self.dst_range = (c["n_users"], c["n_users"] + c["n_items"])
        self.params = ref.make_params(c, seed, dev)
        got = {p: tuple(x.shape) for p, x in ref.leaf_paths(self.params)}
        want = dict(ref.leaf_paths(mdgnn.param_shapes(self.cfg)))
        if got != want:
            raise RuntimeError(f"weight layout {got} is not the program's "
                               f"{want}")
        self.state = mdgnn.init_state(self.cfg, dev)
        self.opt = adamw(c["lr"])
        self.opt_state = self.opt.init(self.params)
        self.step = pipeline.make_train_step(self.cfg, self.opt)
        self.timed = TimedStep(self.step)
        self.log: list = []      # (prev batch, pos batch, negatives key)

    def negatives(self, key: int) -> list:
        """The negatives of every positive batch of one epoch: a source,
        time and mask of a uniform row of the batch, a uniform item as
        destination, zero features."""
        gen = torch.Generator(device=self.src.device).manual_seed(
            mix(self.seed, 100 + key))
        shape = (self.nb, self.b)
        idx = torch.randint(0, self.b, shape, generator=gen,
                            device=self.src.device)
        dst = torch.randint(*self.dst_range, shape, generator=gen,
                            device=self.src.device)
        s, t, m = (x.gather(1, idx) for x in (self.src, self.t, self.mask))
        return [self.EventBatch(s[i], dst[i], t[i], self.zero_feat, m[i])
                for i in range(self.nb)]

    def epoch(self, start: int, stop: int, key: int, deadline=None) -> Feed:
        """`run_epoch` over batches [start, stop), negatives of `key`."""
        feed = Feed(self.batches, start, stop, deadline)
        negs = self.negatives(key)
        with torch.profiler.record_function("chipbench.run_epoch"):
            self.params, self.opt_state, self.state, _ = \
                self.pipeline.run_epoch(
                    self.params, self.opt_state, self.state, feed, self.cfg,
                    self.timed, None, self.dst_range,
                    negatives=(negs[i] for i in range(start + 1, stop)))
        self.log += [(a, b, key) for a, b in zip(feed.yielded,
                                                 feed.yielded[1:])]
        return feed

    def check_steps(self) -> dict:
        """The first steps through the window's own call; the program's
        readings: each step's loss, the first gradient as AdamW holds it
        after one step, and each leaf's change after the steps."""
        start = [x.detach().clone() for _, x in ref.leaf_paths(self.params)]
        seen = {"loss": [], "mu": None, "end": None, "logits": []}

        def hook(out):
            seen["loss"].append(float(out[-1]["loss"]))
            seen["logits"].append((out[-1]["logit_p"], out[-1]["logit_n"]))
            if len(seen["loss"]) == 1:
                seen["mu"] = [x.clone() for _, x in
                              ref.leaf_paths(out[1]["mu"])]
            if len(seen["loss"]) == CHECK_STEPS:
                seen["end"] = [x.detach().clone() for _, x in
                               ref.leaf_paths(out[0])]

        self.timed.hook = hook
        self.epoch(0, CHECK_STEPS + 1, key=-1)
        self.timed.hook = None
        return {"loss": seen["loss"], "logits": seen["logits"],
                "ap": check_ap(seen["logits"]),
                "grad": [float(torch.linalg.norm(m / 0.1))
                         for m in seen["mu"]],
                "change": [float(torch.linalg.norm(e - s))
                           for e, s in zip(seen["end"], start)]}

    def check_inputs(self):
        """The check steps' batches and negatives, as the reference takes
        them: (src, dst, t, feat, mask) tuples."""
        negs = self.negatives(-1)
        cols = lambda e: (e.src, e.dst, e.t, e.feat, e.mask)
        return ([cols(self.batches[i]) for i in range(CHECK_STEPS + 1)],
                [cols(negs[i]) for i in range(1, CHECK_STEPS + 1)])

    def step_sizes(self, steps) -> list:
        """The logical sizes of each logged step (rings replayed from the
        start in the program's fold order)."""
        c = self.config
        rings = frontier.Rings(c, self.src.device)
        out = []
        negs_of: dict = {}
        for prev, pos, key in steps:
            if key not in negs_of:
                negs_of = {key: self.negatives(key)}
            p, n = self.batches[pos], negs_of[key][pos]
            nodes = torch.cat([p.src, p.dst, n.src, n.dst])
            times = torch.cat([p.t, p.t, n.t, n.t])
            valid = torch.cat([p.mask, p.mask, n.mask, n.mask])
            q = self.batches[prev]
            mem = frontier.memory_sizes(c, q.src, q.dst, q.mask)
            out.append(dict(mem, attn=rings.attention_calls(nodes, times,
                                                            valid),
                            pairs=int(p.mask.sum() + n.mask.sum()),
                            d_time=c["d_time"], d_edge=c["d_edge"],
                            d_embed=c["d_embed"]))
            rings.append(q.src, q.dst, q.t, q.mask)
        return out


def check_ap(logits) -> float:
    """The AP of the check steps' logits (a guard beside the compared
    numbers: the scores rank positives above negatives as the
    reference's do)."""
    cat = lambda i: torch.cat([x[i] for x in logits]).cpu().numpy()
    return ref_metrics.average_precision(cat(0), cat(1))


def readings(prog: dict, want: dict) -> dict:
    """The numbers of one side against the reference: the widest gap of a
    first step's score (positive or negative logit); the relative gap of
    the first step's loss, and the widest of the three steps'; of the
    first gradient's norm, by the worst leaf, against that leaf's or the
    median leaf's norm, the larger, and the median leaf's gap; and of each
    leaf's change after the steps, by the worst leaf, over the leaves
    whose reference gradient is above a thousandth of the median leaf's
    at some step (below it a leaf moves under AdamW by rounding).
    `limits/<cell>.json` names those compared: where the first gradient's
    worst leaf swings by rounding, its median leaf stands in (PERF.md
    §6)."""
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["loss"], want["loss"])]
    g_ref = want["grad_norms"][0]
    grad = _worst(prog["grad"], g_ref, range(len(g_ref)))
    g_max = [max(step[j] for step in want["grad_norms"])
             for j in range(len(g_ref))]
    floor = 1e-3 * bench.median([g for g in g_max if g > 0])
    moved = [j for j, g in enumerate(g_max) if g > floor]
    change = _worst(prog["change"], want["change"], moved)
    first = max(float((a - b).abs().max())
                for a, b in zip(prog["logits"][0], want["logits"][0]))
    return {"first_logit_gap": first, "first_loss_gap": gaps[0],
            "loss_gap": max(gaps),
            "grad_gap": grad, "change_gap": change,
            "median_grad_gap": _median_gap(prog["grad"], g_ref, moved)}


def _gaps(got, want, leaves) -> list:
    leaves = list(leaves)
    med = bench.median([want[j] for j in leaves if want[j] > 0])
    return [abs(got[j] - want[j]) / max(want[j], med) for j in leaves]


def _worst(got, want, leaves) -> float:
    return max(_gaps(got, want, leaves))


def _median_gap(got, want, leaves) -> float:
    return bench.median(_gaps(got, want, leaves))


def reference(run_or_inputs, cell: bench.Cell, seed: int, device,
              tf32: bool = False) -> dict:
    """The reference's steps over the check inputs, in float32 with TF32
    off (or on, for the control)."""
    batches, negs = run_or_inputs
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        params = ref.make_params(cell.config, seed, device)
        return ref_train.run_steps(params, cell.config, batches, negs,
                                   cell.traffic["use_pres"],
                                   cell.config["lr"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def as_program(r: dict) -> dict:
    """A reference run's readings in the program's form."""
    return {"loss": r["loss"], "grad": r["grad_norms"][0],
            "change": r["change"], "logits": r["logits"]}


def calibrate(cell: bench.Cell, seed: int, device) -> dict:
    """The program's readings and the control's (the reference in TF32)
    for one seed, with no window: what the limits are set from."""
    t0 = bench.now()
    run = Run(cell, seed, device)
    prog = run.check_steps()
    inputs = run.check_inputs()
    del run
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = reference(inputs, cell, seed, device)
    ctrl = reference(inputs, cell, seed, device, tf32=True)
    return {"seed": seed, "program": readings(prog, want),
            "control": readings(as_program(ctrl), want),
            "seconds": bench.now() - t0}


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool,
        device) -> tuple[dict, dict]:
    """One run of a training cell: (result, checks)."""
    t0 = bench.now()
    r = Run(cell, seed, device)
    prog = r.check_steps()
    bench.sync(device)
    setup_s = bench.now() - t0
    n_check = len(r.log)
    r.timed.seconds.clear()

    # the window
    w0 = bench.now()
    deadline = w0 + seconds
    key = 0
    while not r.epoch(0, r.nb, key, deadline).stopped:
        key += 1
    bench.sync(device)
    window_s = bench.now() - w0
    steps = r.log[n_check:]
    events = sum(r.valid[pos] for _, pos, _ in steps)
    host_s = list(r.timed.seconds)
    eager = r.timed.eager
    result = {"correct": False, "attempted": len(steps), "failed": 0,
              "captured": r.step.captured}
    layer_rec = None
    if trace:
        layer_rec = profile(r, cell, n_check, steps, window_s, host_s, key,
                            device)
    device_desc = bench.device_info(device)
    inputs = r.check_inputs()
    del r
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    c0 = bench.now()
    want = reference(inputs, cell, seed, device)
    got = dict(readings(prog, want), eager_steps=eager)
    # every step, the check steps' and the window's, replays its graph
    limits = dict(cell.limits, eager_steps=0)
    ok, checks = bench.judge(got, limits)
    result["correct"] = ok
    result["check_s"] = bench.now() - c0
    result["check_ap"] = {"program": prog["ap"],
                          "reference": check_ap(want["logits"])}
    result["not_compared"] = {k: v for k, v in got.items()
                              if k not in limits}
    if trace:
        result["metrics"] = bench.read_layer_metrics(cell, layer_rec)
        device_desc.update(busy_s=layer_rec["trace"]["busy_s"],
                           window_s=layer_rec["trace"]["window_s"])
        result["breakdown"] = {k: layer_rec["trace"][k]
                               for k in ("device_ops", "idle_gaps")}
    else:
        result["metrics"] = {
            "train_events_per_s": {"value": events / window_s,
                                   "unit": "events/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = device_desc
    return result, checks


def profile(r: Run, cell: bench.Cell, n_check: int, steps, window_s,
            host_s, key, device) -> dict:
    """The traced run's per-layer record: the window's host step times
    and logical work, then a fresh profiler session over the next steady
    steps (the epoch in progress continued, or the next one)."""
    n = cell.traffic["profile_steps"]
    last = steps[-1][1]
    start, pkey = (last, key) if last + n < r.nb else (0, key + 1)
    before = len(r.log)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("chipbench.window"):
            r.epoch(start, start + n + 1, pkey)
            bench.sync(device)
    dev, host = bench.trace_events(prof)
    (w,) = bench.ranges(host, "chipbench.window")
    sizes = r.step_sizes(r.log)
    kind = bench.device_info(device)["kind"]
    op = "memory_update_table" if r.use_pres else "gru_cell"
    calls = []
    for s in sizes[before:]:
        calls.append((op, s))
        calls += [("embed_attn", a) for a in s["attn"]]
    return {"host_s": {"train_step": host_s}, "window_s": window_s,
            "step_sizes": sizes[n_check:n_check + len(steps)],
            "calls": calls, "peaks": bench.peaks(kind),
            "dev": dev, "host": host, "spans": [w],
            "trace": bench.reduce_trace(dev, host, w)}
