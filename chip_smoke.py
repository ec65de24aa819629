#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE] [--profile TICKS] [--only PHASES]

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit from nvidia-smi; exits 2 when
   CUDA is unavailable or the port's sources are not beside this script.
2. build: nvcc builds every kernel under src/repro_torch/kernels/csrc;
   ptxas's registers, spills and shared memory for each instantiation of
   the bf16 flash_attn kernel, whose SASS must hold wgmma (HGMMA) and TMA
   loads (UTMALDG), and of gru_cell, embed_attn, memory_update (the table
   kernel and the dense memory_update), ssd_chunk and link_score, whose
   SASS must hold mma.sync (HMMA: their 3xTF32 products).
3. edge: each CUDA kernel against its plain PyTorch version at edge shapes
   (M=1, ragged tiles, a node group across a block edge, all-masked rows,
   large time gaps, D % 4 != 0, a misaligned start, K = 1, the K and E
   limits, Din != D, clip bounds hit exactly, both PRES delta modes; for
   gru_cell M at its 64-row tile +- 1, D = 100 with Din = 172 and odd
   widths (its 4-byte copies); for
   embed_attn CONFIG's E = 100 with 2 heads at K = 10, R off its 32-row
   tile at PRODUCTION widths, one table row shared by most slots; for
   flash_attn S = 1, ragged S, T != S, windows, n_rep 1/2/3/4, D 16 to
   256 (80, 96: not multiples of 64; 20: not of 8), S = 8,192, the zoo's
   modes at S = 8,192 (n_rep 7 and 12, D = 256 with a 1,024-key window, D
   = 64 with n_rep 1), fp32 (the FMA kernel) and bf16 (the wgmma kernel,
   held within one bf16 ulp of the fp32 plain version);
   for ssd_chunk L = 1, ragged L, L = 64 and 65, N = 256 with P = 257 at
   G = 1 and 8, P = 8 and 264, a large negative lcum, G = 3 with groups
   of v and h0 off 16-byte boundaries (L P and N P odd), zamba2's Mamba2
   chunk (G = 128, L = 256, N = P = 64, its decays: lcum to about -180,
   the carry-in underflowing); for the table kernel
   M = 2,048 at D = Din = 128 with a hot node across a 64-row tile edge
   and masked rows on tiles' first and last rows, M = 65, Din = 20 with
   D = 12 (its 4-byte copies) across tiles; for link_score D = 21 (its
   4-byte copies), B = 1 with h_items the engine's h[B:] view 84 bytes
   into its buffer, I at its 80- and 160-item blocks +- 1 and at the
   switch between them, B = 17 and 1,024 at I = 20,000, D = 128, and
   D = 172); flash_attn at kimi-k2's D = 112 with n_rep 8 (S = 8,192 and
   a ragged S = 1,000), and the soft-capped blockwise branch of
   nn/attention.py (plain PyTorch) against the dense capped one, with no
   launch).
4. serve-config at the paper model's widths (tgn_pres.CONFIG: d=100,
   d_time=32, K=10, 2 heads, 1 layer) on wiki-small: ServeEngine + replay
   over the serve tail with recommend_topk, the engine as users get it:
   warmup() captures a CUDA graph per bucket for every body (ingest,
   query and top-k, on every route: the fold waits for nothing on the
   host), and every key must be prepared once and captured, with nothing
   prepared during the replay
   (post_warmup_traces empty). The same replay then runs through a
   capture=False engine (events/s, p50/p99, peak memory side by side; AP
   within 1e-3, states within `_compare_states`' tolerances, the same
   launch counts: a replay adds its graph's launches, counted at capture),
   and with kernels_mode="oracle"; the states, query scores and top-k are
   compared.
5. serve-production at the PRODUCTION widths (d=128, d_time=64, K=16, 2
   layers) on the first events of the 120,000-node stream-small graph,
   with a comparison of queries and top-k against the plain path.
   serve-config-apan / serve-production-apan: the same for APAN (mailbox
   attention through neighbor_attn); serve-config-rnn /
   serve-production-rnn: the rnn memory cell, PRES through pres_filter
   (the cell route of mdgnn.memory_update, its fold captured too);
   serve-config-jodie / serve-production-jodie: JODIE with PRES (its time
   projection has no kernel: memory_update_table and link_score).
   serve-config-std (Alg. 1: the gru_cell kernel) / serve-config-plain
   (use_kernels=False: no launch): the cell routes at CONFIG widths, the
   captured engine held to the capture=False one under deterministic
   algorithms with states, query scores and top-k equal.
   serve-parity: serve/parity.py's gate, the captured engine against
   loop.make_eval_step in lock step over wiki-small's first 6,400 events
   (buckets 16 and 64), within 1e-5, each key prepared once.
6. train-config-pres / -std: Alg. 2 (PRES) and Alg. 1 (the gru_cell
   kernel) at CONFIG widths on wiki-small, one epoch (27 lag-one steps at
   b=500) through the epoch loop, then loop.evaluate over the validation
   split; then the same epoch from the same start and negatives through
   the kernels and with kernels_mode="oracle", both under deterministic
   algorithms, compared free-running and step by step.
   train-config-pipe (the pipelined schedule at depth 1, then at depth 2,
   pres_predict on every step), -dense (TGN's dense expansion,
   neighbor_attn), -apan (APAN), -rnn (the rnn cell with PRES: the cell,
   then pres_filter), -rnn-std (the rnn cell, Alg. 1) and -time (PRES
   with the paper's t2 - t1 scale and the mean aggregator, pipelined at
   depth 2), -jodie (JODIE, Alg. 2) and -jodie-std (JODIE, Alg. 1:
   gru_cell), -buckets (PRES with hashed trackers, pres_buckets = |V| /
   16) and -pipe-buckets (the same pipelined at depth 2: pres_predict on
   the bucket means) the same. train-config-plain: TGN-PRES with
   use_kernels=False, the reference's plain route, which must launch no
   kernel, held free-running and step by step against train-config-pres's
   kernel route. After train-config-pres (and -production-pres),
   op-memory-update drives the dense registry op `ops.memory_update`,
   which the model never calls (nor does the JAX package's), forward and
   backward on that phase's occurrence rows.
7. cli: both algorithms for one epoch through the training CLI
   (`python -m repro_torch.launch.train`, its default device); cli-new:
   the CLI with --pipeline-depth 2, --no-dedup-embed and --model apan;
   cli-time: with --pres-scale time; cli-jodie: --model jodie; cli-plain:
   without --use-kernels (no launch); cli-ckpt: the train CLI with
   --checkpoint, then the serve CLI with --checkpoint on the file, and an
   engine restored from it against one built from the trainer's own
   params and state (query scores within TOL); cli-csv: the train CLI with
   --csv tests/data/mini_jodie.csv.
8. train-production-pres / -std / -pipe / -dense / -apan / -rnn / -jodie:
   40 steps at PRODUCTION widths on the first 41,000 stream-small events
   (b=1000), the first 3 steps' losses compared with the plain path; step
   time, events/s and peak device memory.
9. zoo-qwen3 / zoo-xlstm / zoo-zamba2 / zoo-gemma3 / zoo-qwen2 /
   zoo-qwen2vl: the model zoo's last-position prefill (`Model.prefill`)
   at full width (qwen3-0.6b at B=2, S=8192; xlstm-350m at B=2, S=2048;
   zamba2-1.2b at B=2, S=8192; gemma3-12b and qwen2-7b at B=1, S=8192;
   qwen2-vl-2b at B=2 with 256 patches + 7,936 text tokens; random
   weights, tokens and patches from --seed) in float32 through the
   kernels, counted (ZOO: flash_attn once an attention layer, gemma3's 40
   windowed ones too, all on its fp32 route; ssd_chunk once a chunk and
   mLSTM or Mamba2 layer), against the plain route; then timed in the
   published bfloat16 (tokens/s, peak memory; flash_attn's launches all
   on its bf16 wgmma route) and 16 greedy decode steps against an S-slot
   cache (ms a step; decode launches no kernel). zoo-arctic / zoo-kimi /
   zoo-whisper: the same for arctic-480b (1 of 35 layers) and
   kimi-k2-1t-a32b (its dense first layer and one MoE layer) at published
   widths with bfloat16 weights, B = 1, S = 8,192 (flash_attn 1 and 2
   launches; the routing of both routes compared, flips logged), and
   whisper-tiny whole (B = 2, 1,500 frames, 448 tokens; no launch).
   train-zoo-qwen3 / -zamba2 / -xlstm: zoo training at full width (remat
   on, ARCH_OPTIMIZER's optimizer): one fp32 step's loss and every
   gradient leaf and a 2-step free-running loss curve against the plain
   route, launches pinned a step (TRAIN_ZOO), then bf16 steps timed;
   train-zoo-reduced: two steps of each of the ten arches reduced.
   cli-zoo: `python -m repro_torch.launch.serve --zoo` for every arch.
10. kernels: each kernel and its plain version timed (CUDA events around
   the Python call, median: `ms`, host work included where the card waits
   for it; and `device_ms`, the kernel's own CUDA time a call from
   torch.profiler)
   on the largest inputs it received in the phase that captured them (the
   serve phases' probe, through the eager engine, after their counters
   were read; gru_cell during
   the Alg. 1 train phases; pres_predict, neighbor_attn, pres_filter and
   memory_update in a probe of their train phases' path on the trained
   state; flash_attn and ssd_chunk in the zoo's bf16 prefills: a row for
   each zoo phase, and for gemma3's first, windowed, layer too), compared
   there, set beside the card's bound for that work (`work`) and,
   where one PyTorch call computes the same function, beside that call's
   time, by events and on the device (memory_update also beside gru_cell
   then pres_filter; flash_attn with the route that ran, its products'
   TFLOP/s and its share of the bound; embed_attn with its route, the
   fold, the U of its shape and the bound of the form before the fold).
11. train-config-scan / -scan-std / -scan-rnn: macro-batch training
   (train/scan.py, T = 8) of Alg. 2 (the memory_update_table kernel),
   Alg. 1 (the gru_cell kernel) and the rnn cell with PRES (pres_filter),
   each macro step captured as one CUDA graph, at CONFIG widths on
   wiki-small, one epoch + evaluate, against the lag-one loop from the
   same start and generator: the launch counts equal (replays add their
   census), the negatives of the captured and an eager scan equal the
   lag-one draws, and under deterministic algorithms the epoch
   free-running and each macro from the same carry within STEP_TOL, the
   epoch against the plain versions within the free-running limits;
   `captured` true; then events/s of an epoch of each side by side, and
   the busy shares of all six epochs from one profiler session.
   train-production-scan: 40 captured steps at PRODUCTION widths (b
   1,000, T 8), step ms, the first 3 losses against the lag-one loop's.
   train-production-store: tgn_pres.
   PRODUCTION over stream-10m's first 1,000,000 events written by the
   port's converter into a temporary store (its 1,200,000-node space;
   d_edge 32 where PRODUCTION names 172): the store's batches equal the
   in-RAM carve, then 40 steps at b 1,000 through train_phase (the first
   3 losses against the plain path, peak memory). cli-store: both CLIs
   with --event-store. cli-obs: the train CLI with --metrics-out,
   --trace-dir, --trace-steps 4, --scan-chunk 8 and --event-store, the
   serve CLI with --metrics-out and --topk: the manifests name the card
   and its power limit, one obs entry a step, only "compiled" in the
   kernel-dispatch tables, the host spans, the latency histograms and a
   trace. autotune: every registered kernel tuned at the shapes the
   model emits at CONFIG widths into a temporary cache (ms beside the
   plain version's oracle_ms), then a dispatch resolves "compiled" from
   it. The script requires REPRO_KERNELS_MODE unset.

12. train-config-shards (-pipe, -apan, -jodie, -plain, -scan),
   train-production-shard4, train-config-bf16, train-production-bf16,
   cli-shards: memory-parallel training, every shard on this card, and
   bf16 memory tables.
13. spec-mdgnn (-std, -production), spec-mdgnn-compact, -optimized,
   -pipe, -scan: the distributed train spec (train/distributed.py) on a
   1x1 DeviceMesh over an NCCL group of world 1 (an in-memory HashStore),
   three steps of the spec's step through `apply_spec`, each from the
   single-device kernel step's carry (-scan: one macro of three against
   the eager macro step), loss, logits and memory table within STEP_TOL,
   the memory stage's kernel once a step, DTensor's collective counts
   logged; -production at PRODUCTION widths (b 1,000) with both steps'
   ms. The kernel rows also time the dense memory_update on bf16 rows h
   (a bf16 table's) on the edge phase's CONFIG and PRODUCTION inputs.
14. spec-zoo-qwen3, spec-zoo-zamba2, spec-zoo-fsdp, dryrun: the zoo's
   sharded specs (launch/specs.py) on a 1x1 DeviceMesh over an NCCL group
   of world 1, from the seeded weights and tokens of the single-device
   calls they are held against (SPEC_ZOO), under deterministic
   algorithms: qwen3-0.6b's prefill spec (B 2, S 8,192, bfloat16, 28
   flash_attn launches on the wgmma route, through annotate.local), 16
   decode-spec steps (logits and caches, no launch) and one train-spec
   step (B 1, S 4,096: loss, first moments, every parameter leaf; 56
   flash_attn launches); zamba2-1.2b's prefill spec (1,216 ssd_chunk + 6
   flash_attn launches); the reduced gemma3's "fsdp" train spec with the
   weight-gather hook against the same spec without it (the loss);
   ms beside the single-device call's. dryrun: the dry-run CLI
   (launch/dryrun.py) on this host for tgn-pres x train_4k (the
   optimized bundle) and qwen3-0.6b x prefill_32k on the 16x16 mesh of a
   FakeStore group (meta tensors, no device): status "ok" for both.

Every serve, train and zoo phase names the kernels its path must launch;
any other kernel launched fails it. The launch counters are zeroed just
before the phase drives its path and read just after, and the memory
stage's kernel must have launched once a step or fold. `--only` runs some
phases; with no arguments it runs them all.

The second-to-last line is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import logging
import os
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
# and dense bf16 and TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# each output: |kernel - plain| <= TOL * max(1, max|that plain output|), the
# fp32 sums running in another order; the outputs listed in EXACT (by
# position) are copies, not sums, and must be equal (memory_update_table's
# last_t holds the event times it scatters; pres_predict's and pres_filter's
# products, sums and quotient round one by one as the plain version's
# separate kernels do, so their outputs are held exactly too)
TOL = {"memory_update_table": 1e-5, "embed_attn": 1e-4, "link_score": 1e-4,
       "gru_cell": 1e-5, "pres_predict": 0.0, "neighbor_attn": 1e-4,
       "pres_filter": 0.0, "memory_update": 1e-5, "flash_attn": 1e-5,
       "ssd_chunk": 1e-5}
EXACT = {"memory_update_table": (1,), "pres_predict": (0,),
         "pres_filter": (0, 1)}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"memory_update_table": CSRC + "memory_update.cu",
           "embed_attn": CSRC + "embed_attn.cu",
           "link_score": CSRC + "link_score.cu",
           "gru_cell": CSRC + "gru_cell.cu",
           "pres_predict": CSRC + "pres_predict.cu",
           "neighbor_attn": CSRC + "neighbor_attn.cu",
           "pres_filter": CSRC + "pres_filter.cu",
           "memory_update": CSRC + "memory_update.cu",
           "flash_attn": CSRC + "flash_attn_wgmma.cu",
           "ssd_chunk": CSRC + "ssd_chunk.cu"}
# flash_attn's two kernels by route: fp32 inputs on the FMA units, bf16
# inputs on the tensor cores (wgmma fed by TMA)
FLASH_SOURCES = {"fma": CSRC + "flash_attn.cu",
                 "wgmma": CSRC + "flash_attn_wgmma.cu"}
# the model zoo's kernels (prefill only) and the full-width prefill each
# zoo phase drives: arch, batch, text tokens, each kernel's launches a
# prefill (flash_attn once an attention layer, ssd_chunk once a chunk of
# 256 and mLSTM or Mamba2 layer) and how many of flash_attn's are
# windowed. qwen3: 28 layers; xlstm: 21 mLSTM layers x 8 chunks; zamba2:
# 38 Mamba2 layers x 32 chunks and the shared block after each of its 6
# units (38 // 6); gemma3: 48 layers, 40 of them windowed (5 local : 1
# global); qwen2-7b: 28 (n_rep 7); qwen2-vl: 28 (n_rep 6) over 256 patches
# + 7,936 text tokens, so that the 8,192 positions take the blockwise
# branch (S % attn_chunk == 0)
ZOO_KERNELS = ("flash_attn", "ssd_chunk")
ZOO = {"zoo-qwen3": ("qwen3-0.6b", 2, 8192, {"flash_attn": 28}, 0),
       "zoo-xlstm": ("xlstm-350m", 2, 2048, {"ssd_chunk": 21 * 8}, 0),
       "zoo-zamba2": ("zamba2-1.2b", 2, 8192,
                      {"ssd_chunk": 38 * 32, "flash_attn": 6}, 0),
       "zoo-gemma3": ("gemma3-12b", 1, 8192, {"flash_attn": 48}, 40),
       "zoo-qwen2": ("qwen2-7b", 1, 8192, {"flash_attn": 28}, 0),
       "zoo-qwen2vl": ("qwen2-vl-2b", 2, 7936, {"flash_attn": 28}, 0),
       # the MoE family at published widths, cut in depth (ZOO_CUT):
       # arctic-480b's one layer (56 query heads over 8, D = 128) and
       # kimi-k2's dense first layer and one MoE layer (64 over 8, D = 112)
       "zoo-arctic": ("arctic-480b", 1, 8192, {"flash_attn": 1}, 0),
       "zoo-kimi": ("kimi-k2-1t-a32b", 1, 8192, {"flash_attn": 2}, 0),
       # whisper-tiny whole: 1,500 frames, a 448-token decoder; its
       # attention is dense everywhere, so it launches no kernel
       "zoo-whisper": ("whisper-tiny", 2, 448, {}, 0)}
# the zoo phases' cuts of their published configs: depth only, and the
# MoE weights stored in bfloat16 (kimi's 384 experts are 33.8 GB so, 67.6
# GB in float32; the float32 prefill casts them a slice at a time)
ZOO_CUT = {"zoo-arctic": dict(n_layers=1, param_dtype="bfloat16"),
           "zoo-kimi": dict(n_layers=2, param_dtype="bfloat16")}
# zoo training at full width (published config, remat on, each arch's
# ARCH_OPTIMIZER entry at lr 1e-4): arch, batch, sequence, each kernel's
# launches a step. Remat runs each forward kernel twice: in the forward
# and in the recompute; the backward runs the plain versions (no launch).
# qwen3: 28 attention layers x 2 (S = 4,096 = 2 x attn_chunk: the
# blockwise branch); zamba2: 36 Mamba2 blocks in its 6 units x 16 chunks x
# 2, its 2 tail blocks (outside remat) x 16, the shared attention x 6 x 2;
# xlstm: 21 mLSTM layers x 1 chunk x 2 (S = 256, one 256-row chunk: its
# sLSTM loop over time is host-bound, so its length is cut to keep the
# script in its time limit; 512 before PR 25)
TRAIN_ZOO = {"train-zoo-qwen3": ("qwen3-0.6b", 1, 4096, {"flash_attn": 56}),
             "train-zoo-zamba2": ("zamba2-1.2b", 1, 4096,
                                  {"ssd_chunk": 36 * 16 * 2 + 2 * 16,
                                   "flash_attn": 12}),
             "train-zoo-xlstm": ("xlstm-350m", 2, 256, {"ssd_chunk": 42})}
# each reduced arch (attn_chunk=32, the stacked layout, remat on) at B = 2
# and 64 positions: its kernels' launches a step (2 layers; kimi's first,
# dense, layer runs outside remat; zamba2's one unit of 2 Mamba2 blocks
# and the shared block; xlstm's one mLSTM layer; whisper none)
TRAIN_ZOO_REDUCED = {
    "arctic-480b": {"flash_attn": 4}, "xlstm-350m": {"ssd_chunk": 2},
    "gemma3-12b": {"flash_attn": 4}, "command-r-plus-104b": {"flash_attn": 4},
    "qwen2-7b": {"flash_attn": 4}, "kimi-k2-1t-a32b": {"flash_attn": 3},
    "qwen2-vl-2b": {"flash_attn": 4}, "qwen3-0.6b": {"flash_attn": 4},
    "whisper-tiny": {}, "zamba2-1.2b": {"ssd_chunk": 4, "flash_attn": 2}}
# the zoo's sharded specs on a 1x1 DeviceMesh (launch/specs.py), each held
# against the single-device call on the same seeded weights and tokens:
# arch, batch, positions and each kernel's launches of the prefill spec
# (the published bfloat16: flash_attn on its wgmma route; as zoo-qwen3 and
# zoo-zamba2 launch them), and the other specs a phase drives (qwen3: 16
# decode steps against a cache of S slots; one train step at B 1, S 4,096,
# as train-zoo-qwen3: 28 attention layers x 2 with remat)
SPEC_ZOO = {"spec-zoo-qwen3": ("qwen3-0.6b", 2, 8192, {"flash_attn": 28},
                               {"decode": True,
                                "train": (1, 4096, {"flash_attn": 56})}),
            "spec-zoo-zamba2": ("zamba2-1.2b", 2, 8192,
                                {"ssd_chunk": 38 * 32, "flash_attn": 6}, {})}
# the dry run's pairs on the 16x16 mesh: arch, input shape, extra flags
DRYRUN = (("tgn-pres", "train_4k", ["--strategy", "optimized"]),
          ("qwen3-0.6b", "prefill_32k", []))
# zoo training, fp32 kernel route against the plain route: the loss of
# one step from the same parameters and batch within "loss" of its scale;
# each gradient leaf within "grad" of its own largest |g| or of 1e-3 of
# the largest |g| of any leaf (a leaf that vanishes in exact arithmetic
# holds rounding noise); the free running losses within "curve" of their
# scale at every step
TRAIN_ZOO_TOL = {"loss": 1e-5, "grad": 1e-3, "curve": 1e-3}
# train phases whose gradients or free-running losses move under
# rounding-sized perturbations of the zoo kernels' plain outputs by more
# than TRAIN_ZOO_TOL (zamba2's Mamba2 blocks and xlstm's recurrences, as
# in zamba2's prefill): the plain route's own spread under +-1e-6 nudges
# is measured in each of their runs and joins each leaf's and each step's
# limit. The other train phases are held to TRAIN_ZOO_TOL alone
TRAIN_ZOO_NOISE_FLOOR = ("train-zoo-zamba2", "train-zoo-xlstm")
# the free-running curve's steps (3 before PR 25; cut for the script's
# time limit: each step of the noise-floor phases runs four times)
TRAIN_ZOO_STEPS = 2
# the phases whose kernel rows go in the result line (the others' rows go
# to --out and the log)
ZOO_LINE = ("zoo-qwen3", "zoo-xlstm")
# phases whose fp32 logits move under rounding-sized perturbations of the
# zoo kernels' plain outputs by more than ZOO_TOL (`_zoo_noise_floor`,
# measured in every zoo phase): they are held to ZOO_TOL's limit plus
# that spread
ZOO_NOISE_FLOOR = ("zoo-zamba2",)
# MoE phases: a router's top-k set that differs between the routes (a
# "flip": two probabilities within rounding of each other) also moves the
# capacity ranks of later tokens; when one occurs the phase is held as
# ZOO_NOISE_FLOOR's are, and the flips are logged with their margins
# the zoo's last-position prefill logits, kernel route against the plain
# route, both float32: |kernel - plain| <= ZOO_TOL * max(1, max|plain|)
ZOO_TOL = 1e-4
SERVE_KERNELS = ("memory_update_table", "embed_attn", "link_score")
APAN_SERVE_KERNELS = ("memory_update_table", "neighbor_attn", "link_score")
RNN_SERVE_KERNELS = ("pres_filter", "embed_attn", "link_score")
STD_SERVE_KERNELS = ("gru_cell", "embed_attn", "link_score")
# JODIE's embedding is a plain projection: no embedding kernel
JODIE_SERVE_KERNELS = ("memory_update_table", "link_score")
# training against the plain route. Per step, from the same state: loss,
# logits and memory table within fp32 sums in another order. The first
# moments (0.1 x the gradients) are held at 1e-2 of their largest entry as
# one vector and each leaf at 5e-2 of its own: a dropped or misrouted
# gradient path is off by all of itself, while rounding-level differences
# give about 1e-6, except where a pre-activation lies within rounding of a
# ReLU's kink: the two routes then take different sides and one row's
# share of a weight's gradient moves (measured by this script on the H100:
# up to 3.9e-3 of the embedding's output projection over the 27 steps of
# train-config-pres). Free-running over an epoch: train and val AP (the
# routes drift apart chaotically past the first steps, see train_phase;
# both run under deterministic algorithms, so the gap is the same in every
# run of the same code).
STEP_TOL = {"loss": 1e-5, "logits": 1e-4, "memory": 1e-5, "moments": 1e-2,
            "moments_leaf": 5e-2}
AP_LIMIT = 2e-2


# --profile windows, run after the kernel rows: on the H100 a profiler
# session that follows such windows in the same process drops kernels,
# and the rows' device_ms come from sessions of their own
DEFERRED_PROFILES = []
# label -> the window's wall ms, device busy ms and share, launches
PROFILES = {}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def time_ms(fn, reps=None):
    """Median CUDA-event time of fn() in ms, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if reps is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps = max(3, min(25, int(0.5 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps=5, tries=4, by_kernel=None):
    """The device time of fn() in ms a call: the CUDA kernels (and copies)
    torch.profiler records over `reps` calls after a warm-up, summed and
    divided by the calls. Unlike `time_ms`, whose events bracket the
    Python call and so take in the host's work when the card waits for it,
    this counts only the card's own time. A session must record the same
    number of kernels for every call. Late in a long run on the H100,
    sessions now and then record none, in bursts (a fresh process never
    did in 400 sessions), so a session that does not is run again after a
    pause with twice the calls, up to `tries` times; then the measurement
    is reported missing (None) rather than failing the run, since it
    checks nothing about the kernel. `by_kernel`, a dict, receives each
    kernel's own ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        calls = reps << attempt
        if attempt:
            time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n >= calls and n % calls == 0:
            if by_kernel is not None:
                by_kernel.update({e.key: e.self_device_time_total / calls
                                  / 1e3 for e in events})
            return sum(e.self_device_time_total for e in events) / calls / 1e3
    log(f"[device_ms] torch.profiler recorded {n} kernels in {calls} calls "
        f"after {tries} sessions: device_ms not measured")
    return None


def attn_pairs(s, t, causal, window):
    """(query, key) pairs the causal / window mask leaves valid."""
    import numpy as np
    i = np.arange(s)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(name, args, kw=None):
    """(bytes, flops) the call needs on these inputs, flops either a count
    at the fp32 peak or {peak: count}: each input read once,
    each output written once, counting only the rows and slots the data
    uses (valid gathers, selected writes, valid attention slots or pairs).
    fp32 matrix products that run on the tensor cores (gru_cell's,
    memory_update_table's and memory_update's gate products, ssd_chunk's
    four, embed_attn's per-row ones and link_score's two factors) count
    three TF32 products each at the TF32 peak: the least tensor-core work
    that keeps fp32 grade (one rounding misses TOL); `fp32_flops` keeps
    the count of the first three and link_score at the fp32 peak.
    embed_attn counts the form its kernel takes at every shape, the fold
    (q into Wk and the softmax's weighted sum into Wv, per row with a valid
    slot; 2 H c multiply-adds and the time encoding per valid slot);
    `direct_work` keeps the count of the form before it (K/V projected per
    slot, the table part once per distinct row)."""
    kw = kw or {}
    f = 4
    if name == "flash_attn":
        # q k and p v (2 FLOPs a multiply-add, D each) and the softmax's
        # scale, max, exp and sum on each valid pair. With bf16 inputs the
        # products may run on bf16 tensor cores (q k exactly, with fp32
        # accumulation; p v as a bf16 flash kernel does: the wgmma kernel's
        # second product for p's low part is its own cost, not the
        # algorithm's), the softmax on the fp32 units beside them
        import torch
        q, k, _ = args
        g, s, d = q.shape
        gkv, t = k.shape[:2]
        pairs = attn_pairs(s, t, kw.get("causal", True), kw.get("window"))
        nbytes = (2 * g * s * d + 2 * gkv * t * d) * q.element_size()
        if q.dtype == torch.bfloat16:
            return nbytes, {PEAK_BF16: g * pairs * 4 * d,
                            PEAK_FP32: g * pairs * 4}
        return nbytes, g * pairs * (4 * d + 4)
    if name == "ssd_chunk":
        # per group: q k^T on the L(L+1)/2 pairs j <= i (2N) and their
        # product with v (2P), the carry-in (q * exp(lcum)) h0 and the state
        # update (k * w)^T v (2LNP each); the decays (2 a pair), the
        # scalings (4LN) and exp(ltot) h0 + (2NP) on the fp32 units
        q, _, v, _, _ = args
        g, ll, n = q.shape
        p = v.shape[2]
        tri = ll * (ll + 1) // 2
        nbytes = g * (2 * ll * n + 2 * ll * p + ll + 2 * n * p) * f
        return nbytes, {
            PEAK_TF32: 3 * g * (tri * (2 * n + 2 * p) + 4 * ll * n * p),
            PEAK_FP32: g * (2 * tri + 4 * ll * n + 2 * n * p)}
    if name == "memory_update_table":
        # x W on every occurrence, h U on the valid gathers; the gates and
        # the filter (20 D and 10 D an occurrence) on the fp32 units
        table, _, x, g, w_idx, _, w, u, b = args[:9]
        n, d = table.shape
        m, din = x.shape
        valid = int((g < n).sum())
        written = int((w_idx < n).sum())
        # the table's rows at its own width (2 bytes a bf16 value)
        nbytes = (m * (din + d + 4) + (w.numel() + u.numel() + b.numel())
                  + 3 * m * d + written) * f + (
                      valid + written) * d * table.element_size()
        return nbytes, {
            PEAK_TF32: 3 * 2 * 3 * d * (m * din + valid * d),
            PEAK_FP32: m * 30 * d}
    if name == "embed_attn":
        h_self, tab, _, _, valid, tw, _, wq, _, _ = args
        ds = h_self.shape[1]
        e = wq.shape[1]
        c = tab.shape[1] + tw.shape[0]
        heads = kw.get("n_heads", 1)
        live = int(valid.any(1).sum())
        nv = int(valid.sum())
        # per live row: q (ds x E), a_h = Wk_h q_h (E x c), g_h Wv_h
        # (c x E); per valid slot: scores and weighted sum (2 H c each),
        # the angle and cosine, the softmax's max, exp and sum per head
        return direct_work(args)[0], {
            PEAK_TF32: 3 * live * 2 * e * (ds + 2 * c),
            PEAK_FP32: nv * (4 * heads * c + 2 * tw.shape[0] + 4 * heads)}
    if name == "link_score":
        # the factors (B + I rows x D x D) on the tensor cores; the pair
        # pass (the add of the factors and b1, the max, the product with
        # w2 and its sum: 5 a pair-depth element) on the fp32 units
        h_src, h_items, w1, b1, w2, _ = args
        nb, d = h_src.shape
        ni = h_items.shape[0]
        nbytes = ((nb + ni) * d + w1.numel() + 2 * d + 1 + nb * ni) * f
        return nbytes, {PEAK_TF32: 3 * 2 * (nb + ni) * d * d,
                        PEAK_FP32: 5 * nb * ni * d}
    if name == "gru_cell":
        x, h, w, u, b = args
        m, din = x.shape
        d = h.shape[1]
        nbytes = (m * (din + 2 * d) + w.numel() + u.numel() + b.numel()) * f
        return nbytes, {PEAK_TF32: 3 * m * 2 * 3 * d * (din + d),
                        PEAK_FP32: m * 20 * d}
    if name == "pres_predict":
        s_prev, _, _ = args
        m, d = s_prev.shape
        return (3 * m * d + m) * f, 4 * m * d   # mul, max, min, add
    if name == "neighbor_attn":
        # the rows with a valid slot read q, and the valid slots their k
        # and v rows (2 FLOPs an element for the score, 2 for the sum)
        q, k, _, valid = args
        m, e = q.shape
        kk = k.shape[1]
        live = int(valid.any(1).sum())
        nv = int(valid.sum())
        nbytes = (live * e + 2 * nv * e + m * e) * f + m * kk
        return nbytes, nv * (4 * e + 8)
    if name == "pres_filter":
        # three (M, D) rows read, two written, dt and gamma; a multiply,
        # clamp and add (Eq. 7), two multiplies and an add (Eq. 8), a
        # subtract, max and divide (Eq. 9) an element
        s_prev = args[0]
        m, d = s_prev.shape
        return (5 * m * d + m + 1) * f, 10 * m * d
    if name == "memory_update":
        x, h, w, u, b = args[:5]
        m, din = x.shape
        d = h.shape[1]
        # h at its own width (2 bytes a value where a bf16 table's rows)
        nbytes = (m * (din + 4 * d + 1) + w.numel() + u.numel() + b.numel()
                  + 1) * f + m * d * h.element_size()
        return nbytes, {
            PEAK_TF32: 3 * m * 2 * 3 * d * (din + d), PEAK_FP32: m * 30 * d}
    raise SmokeFailure(f"no work count for kernel {name!r}")


def fp32_flops(name, args):
    """The operations of memory_update_table, memory_update, ssd_chunk and
    link_score with every one at the fp32 peak (the bound `work` gave
    before their products moved to the tensor cores); their bytes are
    `work`'s."""
    if name == "link_score":
        h_src, h_items = args[:2]
        nb, d = h_src.shape
        ni = h_items.shape[0]
        return 2 * (nb + ni) * d * d + 5 * nb * ni * d
    if name == "ssd_chunk":
        q, _, v, _, _ = args
        g, ll, n = q.shape
        p = v.shape[2]
        tri = ll * (ll + 1) // 2
        return g * (tri * (2 * n + 2 + 2 * p) + 4 * ll * n * p
                    + 4 * ll * n + 2 * n * p)
    if name == "memory_update_table":
        table, _, x, g = args[:4]
        n, d = table.shape
        din = x.shape[1]
        return int((g < n).sum()) * (2 * 3 * d * (din + d) + 20 * d)
    if name == "memory_update":
        x, h = args[:2]
        m, din = x.shape
        d = h.shape[1]
        return m * (2 * 3 * d * (din + d) + 20 * d) + 10 * m * d
    raise SmokeFailure(f"no fp32 work count for kernel {name!r}")


def direct_work(args):
    """(bytes, flops) of embed_attn in the form before the fold, all at
    the fp32 peak: q, the K/V projection's table part once per distinct
    referenced row and its time-encoding part per valid slot, the scores
    and weighted sum (the bound `work` gave before the fold)."""
    h_self, tab, idx, _, valid, tw, _, wq, wk, _ = args
    r, ds = h_self.shape
    din = tab.shape[1]
    kk = idx.shape[1]
    e = wq.shape[1]
    dtime = tw.shape[0]
    nv = int(valid.sum())
    rows = int(idx[valid].unique().numel())
    nbytes = (r * ds + rows * din + r * kk * 2 + 2 * tw.numel()
              + wq.numel() + 2 * wk.numel() + r * e) * 4 + r * kk
    flops = (2 * r * ds * e + rows * 4 * din * e
             + nv * (4 * dtime * e + 4 * e + 2 * dtime))
    return nbytes, flops


def shape_of(name, a):
    if name == "flash_attn":
        return (f"G={a[0].shape[0]} Gkv={a[1].shape[0]} S={a[0].shape[1]} "
                f"T={a[1].shape[1]} D={a[0].shape[2]} "
                f"{str(a[0].dtype).replace('torch.', '')}")
    if name == "ssd_chunk":
        return (f"G={a[0].shape[0]} L={a[0].shape[1]} N={a[0].shape[2]} "
                f"P={a[2].shape[2]}")
    if name == "memory_update_table":
        return f"M={a[2].shape[0]} D={a[0].shape[1]} Din={a[2].shape[1]}"
    if name == "memory_update":
        return f"M={a[0].shape[0]} D={a[1].shape[1]} Din={a[0].shape[1]}"
    if name == "pres_filter":
        return f"M={a[0].shape[0]} D={a[0].shape[1]}"
    if name == "embed_attn":
        return (f"R={a[0].shape[0]} K={a[2].shape[1]} U={a[1].shape[0]} "
                f"E={a[7].shape[1]}")
    if name == "gru_cell":
        return f"M={a[0].shape[0]} D={a[1].shape[1]} Din={a[0].shape[1]}"
    if name == "pres_predict":
        return f"M={a[0].shape[0]} D={a[0].shape[1]}"
    if name == "neighbor_attn":
        return (f"M={a[0].shape[0]} K={a[1].shape[1]} E={a[0].shape[1]} "
                f"valid={float(a[3].float().mean()):.3f}")
    return f"B={a[0].shape[0]} I={a[1].shape[0]} D={a[0].shape[1]}"


def check_launches(label, counts, expect):
    """The phase's path launched every kernel of `expect` and no other."""
    log(f"[{label}] launches {json.dumps(counts)}")
    require(all(counts[k] > 0 for k in expect),
            f"{label}: a kernel of the path never launched: {counts}")
    require(all(v == 0 for k, v in counts.items() if k not in expect),
            f"{label}: a kernel off the path launched: {counts}")


def memory_stage_kernel(cfg):
    """The kernel the memory stage of `cfg` launches once per step or
    fold, or None (the rnn cell without PRES is plain PyTorch, and the
    plain route, use_kernels=False, launches no kernel)."""
    if not cfg.use_kernels:
        return None
    if cfg.use_pres:
        return "memory_update_table" if cfg.memory_cell == "gru" \
            else "pres_filter"
    return "gru_cell" if cfg.memory_cell == "gru" else None


def bound(name, args, kw=None):
    """The least ms the card could take: bytes over the memory rate or
    the operations of the slowest unit over its peak, the larger."""
    nbytes, flops = work(name, args, kw)
    if not isinstance(flops, dict):
        flops = {PEAK_FP32: flops}
    tb = nbytes / PEAK_BYTES * 1e3
    tf = max(n / peak * 1e3 for peak, n in flops.items())
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def run_pair(name, args, kw):
    """Kernel and plain version on the inputs, private copies for the
    memory-table pass (it writes its table in place); the others get the
    tensors as given (an edge case's misaligned view stays misaligned)."""
    from repro_torch.kernels import ops
    fresh = lambda: ([a.clone() for a in args]
                     if name == "memory_update_table" else list(args))
    got = ops.dispatch(name, *fresh(), mode="compiled", **kw)
    want = ops.dispatch(name, *fresh(), mode="oracle", **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return got, want


def check_kernel(name, args, kw, label):
    """Each output of the kernel against the plain version's, at its own
    scale; returns the largest |kernel - plain| over all outputs. A bf16
    output is held within one bf16 ulp (plus the fp32 tolerance) of the
    plain version computed in fp32 from the same (bf16) inputs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bf16_excess
    got, want = run_pair(name, args, kw)
    torch.cuda.synchronize()
    if got[0].dtype == torch.bfloat16 and name != "memory_update_table":
        want32 = ops.dispatch(name, *[a.float() for a in args],
                              mode="oracle", **kw)
        require(bool(torch.isfinite(got[0].float()).all()),
                f"{name} [{label}]: output is not finite")
        excess, err = bf16_excess(got[0], want32, TOL[name])
        require(excess <= 0, f"{name} [{label}]: bf16 output beyond one ulp "
                f"of the fp32 plain version (max|diff| {err:.3g})")
        return err
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bfloat16:
            # a bf16 table: each row within one bf16 ulp of the plain
            # version's (both round fp32 rows that agree within TOL)
            require(bool(torch.isfinite(g.float()).all()),
                    f"{name} [{label}]: output {i} is not finite")
            excess, err = bf16_excess(g, w.float(), TOL[name])
            require(excess <= 0, f"{name} [{label}]: output {i}: a bf16 row "
                    f"beyond one ulp of the plain version's (max|diff| "
                    f"{err:.3g})")
            worst = max(worst, err)
            continue
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()),
                f"{name} [{label}]: output {i} is not finite")
        if not g.numel():
            continue
        err = float((g - w).abs().max())
        lim = (0.0 if i in EXACT.get(name, ())
               else TOL[name] * max(1.0, float(w.abs().max())))
        require(err <= lim, f"{name} [{label}]: output {i}: max|kernel - "
                f"plain| = {err:.3g} > {lim:.3g}")
        worst = max(worst, err)
    return worst


# the sources whose SASS must hold tensor-core products: HGMMA (wgmma) and
# TMA loads (UTMALDG) for the bf16 flash_attn, HMMA (mma.sync) for the
# 3xTF32 products of gru_cell, embed_attn, memory_update (the table kernel
# and the dense memory_update), ssd_chunk and link_score (its factors)
TENSOR_CORE_SASS = {"flash_attn_wgmma": ("HGMMA", "UTMALDG"),
                    "gru_cell": ("HMMA",), "embed_attn": ("HMMA",),
                    "memory_update": ("HMMA",), "ssd_chunk": ("HMMA",),
                    "link_score": ("HMMA",)}


def check_tensor_core_build(out_dir):
    """For each source of TENSOR_CORE_SASS, print ptxas's registers,
    shared memory, spills (and any wgmma it serialized: none should be)
    for each instantiation, and require its SASS to hold the instructions
    listed there."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    for stem, need in TENSOR_CORE_SASS.items():
        for line in (out_dir / f"{stem}.log").read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "Performance Loss")):
                log(f"[build] ptxas {stem}: {line.strip()}")
        sass = subprocess.run([str(tool), "-sass", str(out_dir /
                                                   f"{stem}.o")],
                              capture_output=True, text=True,
                              timeout=120).stdout
        ops_ = {op: sass.count(op) for op in need}
        log(f"[build] {stem} SASS: {json.dumps(ops_)}")
        require(all(ops_.values()), f"{stem}.o lacks tensor-core (or TMA) "
                f"instructions: {ops_}")


# ---------------------------------------------------------------------------
# phase 3: edge shapes
# ---------------------------------------------------------------------------


def softcap_check(dev):
    """The soft-capped blockwise branch of `nn/attention.py` (plain
    PyTorch: no kernel takes a cap) on the card: `attention` with a chunk
    and a cap launches no kernel and matches the dense capped branch (no
    chunk) within flash_attn's TOL, causal and windowed, at B = 2, S =
    1,024, 8 query heads over 2, D = 64, chunks of 256."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.nn import attention
    from repro_torch.nn.module import ParamBuilder
    gen = torch.Generator(dev).manual_seed(0)
    b = ParamBuilder(gen)
    attention.attention_init(b, "attn", 256, 8, 2, 64, qk_norm=True)
    x = torch.randn((2, 1024, 256), generator=gen, device=dev)
    pos = torch.arange(1024, device=dev)[None].expand(2, 1024)
    worst = 0.0
    for window in (None, 300):
        kw = dict(d_head=64, window=window, softmax_scale_cap=20.0)
        with torch.no_grad():
            ops.reset_launch_counts()
            got = attention.attention(b.params["attn"], x, pos, chunk=256,
                                      **kw)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            want = attention.attention(b.params["attn"], x, pos, **kw)
        require(not any(counts.values()), f"softcap: the capped branch "
                f"launched a kernel: {counts}")
        err = float((got - want).abs().max())
        lim = TOL["flash_attn"] * max(1.0, float(want.abs().max()))
        require(err <= lim, f"softcap window={window}: blockwise vs dense "
                f"{err:.3g} > {lim:.3g}")
        worst = max(worst, err)
        log(f"[edge] softcap window={window}: capped blockwise vs dense "
            f"max_abs_err={err:.3g}, no launch")
    return worst


def edge_cases(dev):
    import numpy as np
    import torch
    from repro_torch.models import mdgnn
    t = lambda a: torch.as_tensor(np.array(a), device=dev)
    rng = np.random.default_rng(0)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    cases = []
    # memory_update_table: a hot node, masked rows, M = 1, Din != D; M at
    # the kernel's 64-row tile + 1, M = 2,048 at PRODUCTION widths with the
    # hot node's 150 occurrences across a tile edge and masked rows on
    # tiles' first and last rows (`edge_rows`), widths off its 16-byte
    # copies (D = 12, Din = 20) over three tiles
    for m, n, d, din, mfrac, hot, edge_rows in [
            (200, 50, 16, 24, 0.0, 70, ()), (24, 10, 8, 8, 0.4, 0, ()),
            (1, 5, 8, 8, 0, 0, ()), (12, 30, 100, 100, 0.2, 3, ()),
            (16, 9, 12, 20, 0.1, 5, ()), (65, 40, 128, 128, 0.1, 9, ()),
            (2048, 500, 128, 128, 0.05, 150, (0, 63, 64, 127, 2047)),
            (150, 60, 12, 20, 0.1, 20, (0, 63, 64))]:
        nodes = rng.integers(0, n, m)
        if hot:
            nodes[rng.choice(m, hot, replace=False)] = 7 % n
        times = np.round(rng.random(m) * 5).astype(np.float32)
        mask = rng.random(m) >= mfrac
        tn, tt, tm = t(nodes).long(), t(times), t(mask)
        order = mdgnn.occurrence_order(tn, tt, tm)
        sel = mdgnn._last_occurrence_flags(tn, tt, tm)
        gidx = torch.where(tm, tn, n + 1)[order].to(torch.int32)
        widx = torch.where(sel, tn, n)[order].to(torch.int32)
        gidx[list(edge_rows)] = n + 1
        widx[list(edge_rows)] = n
        args = [t(f(n, d, sc=0.5)), t(f(n)), t(f(m, din)), gidx, widx,
                tt[order].contiguous(), t(f(din, 3 * d, sc=din ** -0.5)),
                t(f(d, 3 * d, sc=d ** -0.5)), t(f(3 * d, sc=0.1)),
                t(f(m, d, sc=0.3)),
                t(np.round(rng.random(m) * 3).astype(np.float32)),
                t(np.float32(0.37))]
        cases.append(("memory_update_table", args,
                      dict(clip=1.0, delta_mode="transition"),
                      f"M={m} D={d} Din={din} masked={mfrac} hot={hot} "
                      f"masked_rows={list(edge_rows)}"))
        # the same on a bf16 table (mem_dtype="bfloat16": its own
        # instantiation, rows widened on load, rounded on the write)
        cases.append(("memory_update_table",
                      [args[0].to(torch.bfloat16)] + args[1:],
                      dict(clip=1.0, delta_mode="innovation"),
                      f"bf16 table M={m} D={d} Din={din} masked={mfrac} "
                      f"hot={hot} masked_rows={list(edge_rows)}"))
    # embed_attn: R = 1 with K = 1, all-invalid rows, dt to 1e5, K = 64;
    # CONFIG's E = 100 with 2 heads at K = 10 (dh = 50, c = 132: not
    # multiples of 8), R not a multiple of the kernel's 32-row tile at
    # PRODUCTION widths, one row of tab shared by most slots
    for r, u, kk, ds, din, dtime, e, heads, bad, dts, hot in [
            (1, 3, 1, 8, 8, 4, 8, 1, 0, 1.0, 0.0),
            (9, 12, 3, 12, 10, 6, 12, 2, 2, 10.0, 0.0),
            (37, 50, 16, 128, 128, 64, 128, 2, 3, 1e5, 0.0),
            (3, 40, 64, 16, 16, 8, 16, 2, 1, 1e3, 0.0),
            (200, 150, 10, 100, 100, 32, 100, 2, 5, 1e5, 0.0),
            (65, 300, 16, 128, 128, 64, 128, 2, 3, 1e5, 0.0),
            (96, 500, 16, 128, 128, 64, 128, 2, 0, 1e3, 0.9)]:
        valid = rng.random((r, kk)) < 0.7
        valid[:bad] = False
        idx = rng.integers(0, u, (r, kk)).astype(np.int32)
        idx[rng.random((r, kk)) < hot] = 7 % u
        args = [t(f(r, ds)), t(f(u, din)), t(idx),
                t((rng.random((r, kk)) * dts).astype(np.float32)), t(valid),
                t(f(dtime)), t(f(dtime)), t(f(ds, e, sc=ds ** -0.5)),
                t(f(din + dtime, e, sc=(din + dtime) ** -0.5)),
                t(f(din + dtime, e, sc=(din + dtime) ** -0.5))]
        cases.append(("embed_attn", args, dict(n_heads=heads),
                      f"R={r} K={kk} d={din} E={e} heads={heads} dt~{dts:g} "
                      f"hot={hot}"))
    # link_score: B = 1, ragged tiles, 33 sources (three source tiles);
    # D = 21 (rows off 16 bytes and the depth off the 8-deep mma step);
    # B = 1 at D = 21 with h_items = h[B:] as the engine slices it (84
    # bytes into its buffer); I one under and one over the 80-item block
    # and (I = 20,000 is 125 of them) the 160-item one, there with D = 21
    # too; I at the switch between the two on a 132-SM card; B = 17 and
    # 1,024 at the top-k shape (more source tiles, then several a block);
    # D = 172 (two column passes) with each block shape
    for b, i, d, view in [(1, 37, 16, False), (5, 130, 100, False),
                          (33, 20000, 128, False), (5, 130, 21, False),
                          (1, 37, 21, True), (16, 79, 128, False),
                          (16, 81, 128, False), (16, 19999, 128, False),
                          (16, 20001, 21, False), (16, 10560, 128, False),
                          (16, 10561, 128, False), (17, 20000, 128, False),
                          (1024, 20000, 128, False), (16, 300, 172, False),
                          (8, 20001, 172, False)]:
        if view:
            h = t(f(b + i, d))
            hs, hi = h[:b], h[b:]
        else:
            hs, hi = t(f(b, d)), t(f(i, d))
        args = [hs, hi, t(f(2 * d, d, sc=d ** -0.5)), t(f(d, sc=0.1)),
                t(f(d, 1, sc=d ** -0.5)), t(f(1))]
        cases.append(("link_score", args, {},
                      f"B={b} I={i} D={d}"
                      + (f" h_items at +{hi.storage_offset() * 4} bytes"
                         if view else "")))
    # gru_cell: M = 1, ragged tiles, the CONFIG and PRODUCTION widths, M
    # at the kernel's 64-row tile +- 1, D = 100 (not a multiple of its
    # 16-column tile) with Din = 172, widths off its 16-byte copies
    for m, d, din in [(1, 8, 8), (37, 16, 24), (1000, 100, 100),
                      (2000, 128, 128), (63, 128, 128), (65, 128, 128),
                      (129, 100, 172), (45, 21, 37)]:
        args = [t(f(m, din)), t(f(m, d, sc=0.5)),
                t(f(din, 3 * d, sc=din ** -0.5)), t(f(d, 3 * d, sc=d ** -0.5)),
                t(f(3 * d, sc=0.1))]
        cases.append(("gru_cell", args, {}, f"M={m} D={d} Din={din}"))
    # pres_predict: M = 1, ragged M, D % 4 != 0 (the scalar loop), a
    # misaligned start (the scalar loop again), counts of 0 included
    for m, d, off in [(1, 8, 0), (37, 12, 0), (50, 7, 0), (999, 100, 0),
                      (64, 16, 1)]:
        base = [t(f(m * d + off)), t(f(m * d + off, sc=0.4))]
        args = [x[off:].view(m, d) for x in base] + [
            t(np.round(rng.random(m) * 4).astype(np.float32))]
        cases.append(("pres_predict", args, dict(clip=1.0),
                      f"M={m} D={d} offset={off}"))
    # neighbor_attn: M = 1 with K = 1, all-invalid rows (with K = 1 too),
    # ragged M, the CONFIG and PRODUCTION head widths, the K and E limits
    for m, kk, e, bad in [(1, 1, 8, 0), (5, 1, 16, 2), (9, 3, 12, 2),
                          (37, 16, 64, 3), (21, 10, 50, 1), (13, 10, 100, 0),
                          (33, 16, 128, 4), (3, 128, 256, 1)]:
        valid = rng.random((m, kk)) < 0.7
        valid[:bad] = False
        args = [t(f(m, e)), t(f(m, kk, e)), t(f(m, kk, e)), t(valid)]
        cases.append(("neighbor_attn", args, {},
                      f"M={m} K={kk} E={e} invalid_rows={bad}"))
    # pres_filter: M = 1, D % 4 != 0 and a misaligned start (the scalar
    # loop), counts of 0, scale * delta_mean past both clip bounds and
    # exactly on them, both delta modes
    modes = ("transition", "innovation")
    for m, d, off in [(1, 8, 0), (1, 7, 0), (37, 12, 0), (50, 7, 0),
                      (64, 16, 1), (1000, 100, 0)]:
        base = [t(f(m * d + off, sc=sc)) for sc in (0.5, 0.5, 2.0)]
        s_prev, s_meas, dmean = [x[off:].view(m, d) for x in base]
        dt = np.round(rng.random(m) * 4).astype(np.float32)
        dt[:2] = 2.0
        dmean[0, :2] = torch.tensor([0.5, -0.5])
        for mode in modes:
            cases.append(("pres_filter",
                          [s_prev, s_meas, dmean, t(dt), t(np.float32(0.37))],
                          dict(clip=1.0, delta_mode=mode),
                          f"M={m} D={d} offset={off} {mode}"))
    # memory_update (dense): M = 1, M = 129 (a ragged last block), Din != D,
    # the CONFIG and PRODUCTION widths, M at the 64-row tile + 1, widths
    # off the 16-byte copies, both delta modes
    for m, d, din in [(1, 8, 8), (129, 16, 16), (37, 20, 36), (1000, 100, 100),
                      (2000, 128, 128), (65, 128, 128), (45, 21, 37)]:
        args = [t(f(m, din)), t(f(m, d, sc=0.5)),
                t(f(din, 3 * d, sc=din ** -0.5)), t(f(d, 3 * d, sc=d ** -0.5)),
                t(f(3 * d, sc=0.1)), t(f(m, d, sc=0.3)),
                t(np.round(rng.random(m) * 3).astype(np.float32)),
                t(np.float32(0.37))]
        for mode in modes:
            cases.append(("memory_update", args,
                          dict(clip=1.0, delta_mode=mode),
                          f"M={m} D={d} Din={din} {mode}"))
        # bf16 rows h (a bf16 table's), widened on load
        cases.append(("memory_update",
                      [args[0], args[1].to(torch.bfloat16)] + args[2:],
                      dict(clip=1.0, delta_mode="innovation"),
                      f"bf16 h M={m} D={d} Din={din}"))
    # flash_attn: S = 1, ragged S and T (not multiples of the 64-row
    # tiles), T != S both ways, windows (a window that leaves late rows
    # with no valid key when T < S: the mean of v), n_rep 1 / 2 / 3 / 4,
    # D 16 to 256 (80 and 96: multiples of 16, not of the wgmma route's
    # 64-column panels; 20: not a multiple of 8, padded for TMA), S = 8,192
    # causal, non-causal, fp32 (the FMA route) and bf16 (the wgmma route);
    # and the zoo's modes at S = 8,192: n_rep 7 (qwen2-7b's 28 heads over
    # 4), n_rep 12 (command-r-plus's 96 over 8, two kv heads of it), D =
    # 256 with a 1,024-key window (gemma3's local layers), D = 64 with
    # n_rep 1 (zamba2's shared attention), and kimi-k2's D = 112 with n_rep
    # 8 (14 columns of 8: the wgmma route's second 64-column panel reads
    # past the row and must see zeros) at S = 8,192 and at a ragged S
    for g, gkv, s_, t_, d, causal, window in [
            (1, 1, 1, 1, 64, True, None), (4, 2, 1, 37, 128, False, None),
            (2, 2, 100, 100, 64, True, None), (8, 2, 130, 130, 128, True, 50),
            (4, 1, 64, 200, 64, True, None), (4, 4, 200, 64, 40, True, None),
            (2, 1, 200, 50, 64, True, 10), (6, 3, 257, 257, 256, False, 70),
            (32, 16, 300, 300, 128, True, None),
            (3, 3, 129, 65, 16, False, None),
            (4, 2, 190, 190, 96, True, None), (2, 2, 100, 77, 80, False, 30),
            (6, 2, 150, 150, 128, True, None), (3, 1, 70, 70, 20, True, None),
            (4, 2, 8192, 8192, 128, True, None),
            (28, 4, 8192, 8192, 128, True, None),
            (24, 2, 8192, 8192, 128, True, None),
            (16, 8, 8192, 8192, 256, True, 1024),
            (8, 8, 8192, 8192, 64, True, None),
            (64, 8, 8192, 8192, 112, True, None),
            (16, 2, 1000, 1000, 112, True, None)]:
        for dt in (torch.float32, torch.bfloat16):
            args = [t(f(g, s_, d, sc=0.5)).to(dt),
                    t(f(gkv, t_, d, sc=0.5)).to(dt),
                    t(f(gkv, t_, d)).to(dt)]
            cases.append(("flash_attn", args,
                          dict(causal=causal, window=window),
                          f"G={g} Gkv={gkv} S={s_} T={t_} D={d} "
                          f"causal={causal} window={window} "
                          f"{str(dt).replace('torch.', '')}"))
    # ssd_chunk: L = 1, ragged L (not a multiple of the kernel's 32-row
    # tiles), L = 64 and 65 (two tiles exactly, and one row more), the xLSTM
    # widths N = 256, P = 257 at G = 8 and G = 1 (and its reduced N = 64,
    # P = 65), a large negative lcum (exp underflows to 0), P above 256 (a
    # third slab), N = 33 (not a multiple of 8), P = 8 (one column tile),
    # P = 264 (33 full tiles), and G = 3 with L P (and N P) odd, so the
    # later groups' v (and h0) start off a 16-byte boundary
    for g, ll, n, p, lsc in [(1, 1, 8, 9, 0.05), (3, 100, 16, 17, 0.05),
                             (8, 256, 256, 257, 0.05), (2, 300, 64, 65, 0.05),
                             (2, 256, 256, 257, 4.0), (1, 40, 33, 400, 0.5),
                             (2, 64, 64, 8, 0.05), (1, 65, 40, 264, 0.05),
                             (1, 256, 256, 257, 0.05), (3, 3, 33, 9, 0.05),
                             (3, 51, 64, 257, 0.05)]:
        lcum = np.cumsum(-np.abs(f(g, ll, sc=lsc)), -1).astype(np.float32)
        args = [t(f(g, ll, n, sc=0.1)), t(f(g, ll, n, sc=0.1)),
                t(f(g, ll, p, sc=0.5)), t(lcum), t(f(g, n, p, sc=0.5))]
        cases.append(("ssd_chunk", args, {},
                      f"G={g} L={ll} N={n} P={p} min_lcum="
                      f"{float(lcum.min()):.1f}"))
    # ssd_chunk at zamba2's Mamba2 chunk: B = 2 x 64 heads, L = 256, N = P
    # = 64, q = C shared by a batch row's heads, k = B * dt, and the decays
    # of A_log = 0: log a = -softplus(.), about -0.7 a step, so lcum falls
    # to about -180 and exp(lcum) (the carry-in) underflows late in the
    # chunk; a nonzero h0, as every chunk after the first has
    g, ll, n, p, heads = 128, 256, 64, 64, 64
    dt = np.log1p(np.exp(f(g, ll)))
    c_ssm = np.repeat(f(g // heads, ll, n, sc=0.5), heads, axis=0)
    b_ssm = np.repeat(f(g // heads, ll, n, sc=0.5), heads, axis=0)
    lcum = np.cumsum(-dt, -1).astype(np.float32)
    args = [t(c_ssm), t((b_ssm * dt[..., None]).astype(np.float32)),
            t(f(g, ll, p, sc=0.5)), t(lcum), t(f(g, n, p, sc=0.5))]
    cases.append(("ssd_chunk", args, {},
                  f"G={g} L={ll} N={n} P={p} Mamba2 decays min_lcum="
                  f"{float(lcum.min()):.1f}"))
    return cases


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


class Capture:
    """Keeps a copy of the largest inputs each kernel of `names` (None:
    all) received while it is entered, the latest among equals, or with
    `latest=False` the first (a timed run then copies only when a larger
    input arrives); the launch goes through unchanged."""

    def __init__(self, names=None, latest=True):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = dict(ops.REGISTRY)
        self.names = set(self.saved if names is None else names)
        self.latest = latest
        self.best = {}

    @staticmethod
    def size(name, args):
        if name == "memory_update_table":
            return args[2].shape[0]
        if name == "gru_cell":
            return args[0].shape[0]
        if name == "link_score":
            return args[0].shape[0] * args[1].shape[0]
        if name == "pres_predict":
            return args[0].numel()
        if name == "neighbor_attn":
            return args[1].numel()
        if name == "pres_filter":
            return args[0].numel()
        if name == "memory_update":
            return args[0].shape[0]
        if name in ZOO_KERNELS:
            return args[0].numel()
        return args[0].shape[0] * args[2].shape[1]

    def __enter__(self):
        def wrap(name, fn):
            def run(*args, **kw):
                s = self.size(name, args)
                top = self.best.get(name, (-1,))[0]
                if s > top or (self.latest and s == top):
                    self.best[name] = (s, [a.clone() for a in args], dict(kw))
                return fn(*args, **kw)
            return run
        for name, spec in self.saved.items():
            if name in self.names:
                self.ops.REGISTRY[name] = dataclasses.replace(
                    spec, cuda=wrap(name, spec.cuda))
        return self

    def __exit__(self, *exc):
        self.ops.REGISTRY.update(self.saved)


def _compare_states(a, b, label, tol=1e-4):
    """Rings, times and counts exact; table, tracker sums and mailbox
    messages to `tol` (1e-4: the trackers are index_add_ sums whose CUDA
    atomics order varies; 0.0 where both ran under deterministic
    algorithms). The dump rows (last row of rings, trackers and mailbox)
    are not state."""
    import torch
    for key in ("nbr", "t", "ptr"):
        require(torch.equal(a["neighbors"][key][:-1],
                            b["neighbors"][key][:-1]),
                f"{label}: neighbour {key} differ")
    require(torch.equal(a["memory"].last_update, b["memory"].last_update),
            f"{label}: last_update differ")
    pa, pb = a["pres"].rows(), b["pres"].rows()
    require(torch.equal(pa.n, pb.n), f"{label}: pres.n differ")
    errs = {}
    if "mailbox" in a:
        for key in ("t", "ptr"):
            require(torch.equal(a["mailbox"][key][:-1], b["mailbox"][key][:-1]),
                    f"{label}: mailbox {key} differ")
        x, y = a["mailbox"]["msg"][:-1], b["mailbox"]["msg"][:-1]
        err = float((x - y).abs().max())
        require(err <= tol * max(1.0, float(y.abs().max())),
                f"{label}: mailbox messages differ by {err:.3g}")
        errs["mailbox"] = err
    for key, x, y in [("memory", a["memory"].mem, b["memory"].mem),
                      ("xi", pa.xi, pb.xi), ("psi", pa.psi, pb.psi)]:
        err = float((x - y).abs().max())
        scale = max(1.0, float(y.abs().max()))
        require(err <= tol * scale, f"{label}: {key} differ by {err:.3g}")
        errs[key] = err
    return errs


def _report(label, rep, counts, engine):
    import torch
    log(f"[{label}] events={rep.n_events} ticks={rep.n_ticks} "
        f"events/s={rep.events_per_sec:.1f} "
        f"ingest p50={rep.ingest_p50_ms:.3f}ms p99={rep.ingest_p99_ms:.3f}ms "
        f"query p50={rep.query_p50_ms:.3f}ms p99={rep.query_p99_ms:.3f}ms "
        f"online_AP={rep.online_ap:.4f} "
        f"post_warmup_traces={dict(rep.post_warmup_traces)}")
    st = engine.state
    mb = lambda *ts: sum(x.numel() * x.element_size() for x in ts) / 1e6
    box = (f" mailbox={mb(*st['mailbox'].values()):.1f}"
           if "mailbox" in st else "")
    log(f"[{label}] state MB: memory={mb(st['memory'].mem):.1f} "
        f"trackers={mb(st['pres'].xi, st['pres'].psi, st['pres'].n):.1f} "
        f"rings={mb(*st['neighbors'].values()):.1f}{box}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB allocated,"
        f" {torch.cuda.max_memory_reserved() / 1e6:.1f} MB reserved")


def check_captured(label, eng, kinds=("ingest", "query", "topk")):
    """Every key the engine prepared, once, and a CUDA graph for each:
    every body of every config is captured (a capture that failed would
    have raised), and among them a key of each body in `kinds`."""
    graphs = sorted(k for k, slot in eng._slots.items()
                    if slot.graph is not None)
    log(f"[{label}] trace_counts {sorted(eng.trace_counts.items())}; "
        f"captured {graphs}")
    require(all(c == 1 for c in eng.trace_counts.values()),
            f"{label}: a key prepared twice: {dict(eng.trace_counts)}")
    require(len(graphs) == len(eng._slots)
            and set(kinds) <= {k[0] for k in graphs},
            f"{label}: captured {graphs} of {sorted(eng._slots)}, expected "
            f"every key, and the {sorted(kinds)} bodies among them")
    return graphs


def serve_phase(label, cfg, stream, dst_range, dev, *, rate, tick,
                max_events, query_batch, topk_src, k, oracle_replay,
                big_query, probe, expect=SERVE_KERNELS, profile=0,
                exact=False):
    """The engine as users get it (a CUDA graph per bucket and body),
    warmed up, then the replay, a large query and top-k with the launch
    counters set to 0 just before and read just after; the same through a
    capture=False engine, held to it (AP within 1e-3, states within
    `_compare_states`' tolerances, the same launch counts; with `exact`
    both run under deterministic algorithms and states, query scores and
    top-k must be equal); then the plain versions (kernels_mode=
    "oracle")."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.serve import MicroBatcher, ServeEngine, replay

    def engine(mode, capture=True):
        c = dataclasses.replace(cfg, kernels_mode=mode)
        params = mdgnn.init_params(c, torch.Generator().manual_seed(0), dev)
        return ServeEngine(c, params, mdgnn.init_state(c, dev),
                           batcher=MicroBatcher(d_edge=stream.feat_dim),
                           item_range=dst_range, device=dev, capture=capture)

    kw = dict(rate=rate, tick=tick, query_batch=query_batch, seed=0,
              max_events=max_events, warmup=False)
    q_src, q_dst = stream.src[:big_query], stream.dst[:big_query]
    q_t = np.full(big_query, stream.t[max_events - 1], np.float32)
    ts = np.full(len(topk_src), stream.t[max_events - 1], np.float32)

    def drive(eng):
        """Warm-up (the captures), then the counted run: (report, counts,
        folds, scores, top-k values and ids, warm-up s, peak MB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
        res0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup(query=True, topk_k=k)
        warm_s = time.perf_counter() - t0
        folds = [0]
        fold = eng._fold

        def counted(batch):
            folds[0] += 1
            return fold(batch)
        eng._fold = counted
        ops.reset_launch_counts()
        rep = replay(eng, stream, dst_range, **kw)
        scores = eng.query(q_src, q_dst, q_t)
        vals, ids = eng.recommend_topk(topk_src, ts, k)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        del eng._fold
        # the engine's own: peak allocated and reserved above the start
        # (its state was made before; earlier engines' pools stay out)
        peak = {"allocated": (torch.cuda.max_memory_allocated()
                              - alloc0) / 1e6,
                "reserved": (torch.cuda.max_memory_reserved() - res0) / 1e6}
        return rep, counts, folds[0], scores, vals, ids, warm_s, peak

    det = _deterministic if exact else contextlib.nullcontext
    eng = engine("auto")
    with det():
        rep, counts, folds, scores, vals, ids, warm_s, peak = drive(eng)
    _report(label, rep, counts, eng)
    graphs = check_captured(label, eng)
    summary = {"events": rep.n_events, "folds": folds,
               "events_per_s": rep.events_per_sec,
               "ingest_p50_ms": rep.ingest_p50_ms,
               "ingest_p99_ms": rep.ingest_p99_ms,
               "query_p50_ms": rep.query_p50_ms,
               "query_p99_ms": rep.query_p99_ms, "online_ap": rep.online_ap,
               "peak_mem_mb": peak["allocated"],
               "peak_reserved_mb": peak["reserved"], "warmup_s": warm_s,
               "captured": [list(g) for g in graphs],
               "post_warmup_traces": {" ".join(map(str, key)): c for key, c
                                      in rep.post_warmup_traces.items()}}
    require(not rep.post_warmup_traces,
            f"{label}: the replay prepared keys after warm-up: "
            f"{rep.post_warmup_traces}")
    check_launches(label, counts, expect)
    stage = memory_stage_kernel(cfg)
    require(stage is None or counts[stage] == folds, f"{label}: {stage} "
            f"launched {counts.get(stage)} times in {folds} folds")
    require(np.isfinite(scores).all() and scores.shape == (big_query,),
            f"{label}: bad query scores")
    require(vals.shape == (len(topk_src), k) and np.isfinite(vals).all()
            and ((ids >= dst_range[0]) & (ids < dst_range[1])).all(),
            f"{label}: bad top-k output")
    require(0.0 <= rep.online_ap <= 1.0, f"{label}: AP out of range")

    # the same replay through the engine without graphs
    eager = engine("auto", capture=False)
    with det():
        rep_e, counts_e, folds_e, scores_e, vals_e, ids_e, warm_e, peak_e = \
            drive(eager)
    errs = _compare_states(eng.state, eager.state, f"{label} vs eager",
                           tol=0.0 if exact else 1e-4)
    e_err = max(float(np.abs(scores - scores_e).max()),
                float(np.abs(vals - vals_e).max()))
    require(not exact or (e_err == 0.0 and np.array_equal(ids, ids_e)),
            f"{label}: query scores or top-k differ from the eager "
            f"engine's (max |diff| {e_err:.3g})")
    summary["eager"] = {
        "events_per_s": rep_e.events_per_sec,
        "ingest_p50_ms": rep_e.ingest_p50_ms,
        "ingest_p99_ms": rep_e.ingest_p99_ms,
        "query_p50_ms": rep_e.query_p50_ms,
        "query_p99_ms": rep_e.query_p99_ms, "online_ap": rep_e.online_ap,
        "peak_mem_mb": peak_e["allocated"],
        "peak_reserved_mb": peak_e["reserved"], "warmup_s": warm_e,
        "state_diff": errs, "score_diff": e_err}
    log(f"[{label}] captured / eager: events/s {rep.events_per_sec:.1f} / "
        f"{rep_e.events_per_sec:.1f}, ingest p50 {rep.ingest_p50_ms:.3f} / "
        f"{rep_e.ingest_p50_ms:.3f} ms, p99 {rep.ingest_p99_ms:.3f} / "
        f"{rep_e.ingest_p99_ms:.3f} ms, query p50 {rep.query_p50_ms:.3f} / "
        f"{rep_e.query_p50_ms:.3f} ms, p99 {rep.query_p99_ms:.3f} / "
        f"{rep_e.query_p99_ms:.3f} ms, AP {rep.online_ap:.6f} / "
        f"{rep_e.online_ap:.6f}, post_warmup_traces "
        f"{dict(rep.post_warmup_traces)} / {dict(rep_e.post_warmup_traces)}, "
        f"peak MB above the start, allocated {peak['allocated']:.1f} / "
        f"{peak_e['allocated']:.1f}, reserved {peak['reserved']:.1f} / "
        f"{peak_e['reserved']:.1f}, warm-up {warm_s:.2f} / {warm_e:.2f} s; "
        f"max|state diff| {json.dumps(errs)}, max|score diff| {e_err:.3g}")
    require(abs(rep.online_ap - rep_e.online_ap) <= 1e-3,
            f"{label}: AP {rep.online_ap} captured vs {rep_e.online_ap} "
            f"eager")
    require(counts_e == counts and folds_e == folds,
            f"{label}: launches {counts} in {folds} folds captured, "
            f"{counts_e} in {folds_e} eager")

    plain = engine("oracle", capture=False)
    if oracle_replay:
        rep_o = replay(plain, stream, dst_range, **kw)
        errs = _compare_states(eng.state, plain.state, label)
        summary["vs_plain_state"] = errs
        log(f"[{label}] oracle replay: AP={rep_o.online_ap:.4f} "
            f"max|state diff| {json.dumps(errs)}")
        require(abs(rep_o.online_ap - rep.online_ap) <= 1e-3,
                f"{label}: AP {rep.online_ap} vs oracle {rep_o.online_ap}")
    else:
        plain.state = eng.state          # same state, plain kernels
    s_o = plain.query(q_src, q_dst, q_t)
    v_o, _ = plain.recommend_topk(topk_src, ts, k)
    q_err = float(np.abs(scores - s_o).max())
    k_err = float(np.abs(vals - v_o).max())
    log(f"[{label}] vs plain path: max|query diff|={q_err:.3g} "
        f"max|top-k score diff|={k_err:.3g}")
    summary.update(vs_plain_query=q_err, vs_plain_topk=k_err)
    require(q_err <= 1e-3 * max(1.0, float(np.abs(s_o).max())),
            f"{label}: query scores differ from the plain path by {q_err}")
    require(k_err <= 1e-3 * max(1.0, float(np.abs(v_o).max())),
            f"{label}: top-k scores differ from the plain path by {k_err}")

    # phase 10's inputs: one more fold, query and top-k on the eager
    # engine's final state (a graph replay calls no wrapper to capture
    # them from), made after the counters were read
    with Capture() as cap:
        hi = max_events + probe
        eager.ingest(stream.src[max_events:hi], stream.dst[max_events:hi],
                     stream.t[max_events:hi], stream.feat[max_events:hi])
        eager.query(q_src, q_dst, q_t)
        eager.recommend_topk(topk_src, ts, k)
        torch.cuda.synchronize()
    if profile:
        for tag, e in ((label, eng), (f"{label}-eager", eager)):
            DEFERRED_PROFILES.append(functools.partial(
                _profile, tag, e, stream, max_events + probe, profile,
                q_src[:64], q_dst[:64], q_t[:64]))
    return counts, cap.best, summary


def _profile(label, eng, stream, lo, ticks, q_src, q_dst, q_t):
    """torch.profiler over `ticks` rounds of (64-pair query, then a fold of
    the next 1/ticks of the remaining events): device time by kernel and
    the device busy share of the window's wall time (the profiler's own
    host overhead is inside that wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step = (len(stream) - lo) // ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in range(ticks):
            a, b = lo + w * step, lo + (w + 1) * step
            eng.query(q_src, q_dst, q_t)
            eng.ingest(stream.src[a:b], stream.dst[a:b], stream.t[a:b],
                       stream.feat[a:b])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(label, prof, wall_us, f"{ticks} x (query 64 pairs + "
                    f"fold {step} events)")


def _profile_prefill(label, dev, seed):
    """torch.profiler over one bf16 prefill of the zoo phase's model, its
    weights and batch drawn again from `seed` (a deferred window holds no
    phase's weights: gemma3-12b's 47 GB would not fit beside the next)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.archs.api import get_model
    cfg, _, params, batch = zoo_inputs(label, dev, seed)
    bf = get_model(cfg)
    with torch.no_grad():
        bf.prefill(params, batch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bf.prefill(params, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    del params, batch
    torch.cuda.empty_cache()
    _report_profile(label, prof, wall_us, "one bf16 prefill")


# the prefix of `_profile_windows`' record_function ranges
WINDOW = "window#"


def _is_range(name):
    """A record_function range's device-side entry, not a kernel: the
    engine's and the train step's stages (obs.trace.stage; those span
    their kernels and the gaps between them) and `_profile_windows`'."""
    return (name.startswith(("serve_", "step#", WINDOW))
            or name in ("memory_update", "embed", "loss", "apply"))


def _report_profile(label, prof, wall_us, what):
    """Device time by kernel and the device busy share of the window's
    wall time (the profiler's own host overhead is inside that wall
    time)."""
    import torch
    _report_kernels(label, [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not _is_range(e.key)], wall_us, what)


def _report_kernels(label, rows, wall_us, what):
    """Log and record (PROFILES) a window's kernels, rows of (name,
    device us, launches): the busy time and share of its wall time."""
    busy_us = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    PROFILES[label] = {"window": what, "wall_ms": wall_us / 1e3,
                       "busy_ms": busy_us / 1e3,
                       "busy_share": busy_us / wall_us,
                       "launches": launches}
    log(f"[{label}] profile: {what}: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), "
        f"{launches} kernel launches")
    for name, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[{label}] profile: {us / 1e3:9.3f} ms {n:6d} x {name[:90]}")


def _profile_windows(windows):
    """ONE torch.profiler session over `windows`, each (label, run, what):
    run() between two synchronizations, inside a record_function range of
    its own, and the window's device busy time the kernels that began
    within that range. The scan phases' windows share this session, the
    first of the process, so no CUDA graph replay is traced by a session
    that follows another."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, run, _ in windows:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(WINDOW + label):
                run()
                torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    spans = {e.name[len(WINDOW):]: e.time_range for e in events
             if e.device_type == DeviceType.CPU
             and e.name.startswith(WINDOW)}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not _is_range(e.name)]
    for label, _, what in windows:
        require(label in spans, f"{label}: the profile has no range of "
                f"its window")
        span, by = spans[label], {}
        for e in kernels:
            if span.start <= e.time_range.start <= span.end:
                us, n = by.get(e.name, (0.0, 0))
                by[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        _report_kernels(label, [(k, us, n) for k, (us, n) in by.items()],
                        walls[label], what)


# ---------------------------------------------------------------------------
# phases 6-8: training
# ---------------------------------------------------------------------------


def _clone(params, opt_state, state, pstate=None):
    """Copies of a training carry that share no storage with it: (params,
    opt_state, state) and, on the pipelined schedule, the snapshot."""
    from repro_torch.models import mdgnn
    from repro_torch.train.pipeline import PipelineState
    from repro_torch.utils.tree import tree_map
    out = (tree_map(lambda t: t.detach().clone(), params),
           tree_map(lambda t: t.clone(), opt_state),
           mdgnn.clone_state(state))
    if pstate is None:
        return out
    return out + (PipelineState(pstate.read_mem.clone(),
                                pstate.read_last_update.clone(),
                                pstate.pending.clone(), pstate.tick),)


def _run_train(cfg, opt, start, batches, steps, negs, val, dst_range, timed):
    """pipeline.run_epoch (the lag-one loop at depth 0) over the first
    `steps` steps from clones of `start` = (params, opt_state, state), then
    loop.evaluate when `val` = (batches, negatives) is given. Returns
    (per-step losses, per-step device-synced seconds (timed runs),
    EpochResult, (val AP, val AUC) or None, final state, final params)."""
    import torch
    from repro_torch.train import loop, pipeline
    params, opt_state, state = _clone(*start)
    step = pipeline.make_train_step(cfg, opt)
    losses, secs = [], []

    def recorded(*a):
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = step(*a)
        if timed:
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        losses.append(out[-1]["loss"])
        return out

    params, opt_state, state, res = pipeline.run_epoch(
        params, opt_state, state, batches[:steps + 1], cfg, recorded, None,
        dst_range, negatives=negs[:steps])
    ev = None
    if val is not None:
        _, vap, vauc = loop.evaluate(params, state, val[0], cfg,
                                     loop.make_eval_step(cfg), None,
                                     dst_range, negatives=val[1])
        ev = (vap, vauc)
    return [float(x) for x in losses], secs, res, ev, state, params


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms: index_add_ (the mean aggregator,
    the PRES statistics) and the gathers' backward sum in index order, not
    in the order atomics land, so a run gives the same numbers every time.
    Any op without a deterministic version raises. cuBLAS is deterministic
    on one stream, which is all this script uses; torch's alert for it
    (it asks for CUBLAS_WORKSPACE_CONFIG, read once per process, which
    slowed the timed runs' host-bound steps on the H100) is silenced."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "error", message=".*does not have a deterministic")
            warnings.filterwarnings("ignore", message=".*it uses CuBLAS")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def _carry(cfg, start):
    """Clones of `start`, with a fresh snapshot on the pipelined schedule."""
    from repro_torch.train.pipeline import PipelineState
    carry = _clone(*start)
    if cfg.pipeline_depth:
        carry += (PipelineState.init(carry[2]["memory"]),)
    return carry


def _profile_train(label, cfg, opt, start, batches, negs, n):
    """torch.profiler over train steps 2..n+1 from clones of `start` (the
    first step, unprofiled, warms the allocator)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import pipeline
    step = pipeline.make_train_step(cfg, opt)
    carry = step(*_carry(cfg, start), batches[0], batches[1], negs[0])[:-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n + 1):
            carry = step(*carry, batches[i], batches[i + 1], negs[i])[:-1]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(label, prof, wall_us, f"{n} train steps")


def _step_vs_plain(cfg, opt, start, batches, negs, steps, other,
                   k_step=None):
    """Every step of `cfg`'s route against the step of `other` (the plain
    versions of the kernels, or for the plain route the kernel route)
    taken from the SAME parameters, optimizer state and model state (and,
    on the pipelined schedule, snapshot), so no difference is carried from
    one step to the next. Returns the worst relative difference of each
    quantity over the steps: the loss, the logits, the memory table after
    the step (and the snapshot), and the optimizer's first moments (after
    one step 0.1 x the gradient) as one vector and leaf by leaf, with the
    worst leaf's name. `k_step` replaces `cfg`'s step (a sharded step on
    the natural carry, `_natural_step`)."""
    from repro_torch.train import pipeline
    from repro_torch.utils.tree import tree_leaves
    carry = _carry(cfg, start)
    k_step = k_step or pipeline.make_train_step(cfg, opt)
    p_step = pipeline.make_train_step(other, opt)
    amax = lambda t: float(t.abs().max())
    rel = lambda a, b, floor: amax(a - b) / max(floor, amax(b))
    names = _leaf_names(start[0])
    worst = {"loss": 0.0, "logits": 0.0, "memory": 0.0, "moments": 0.0,
             "moments_leaf": 0.0, "worst_leaf": None}
    for i in range(steps):
        p_out = p_step(*_clone(*carry), batches[i], batches[i + 1], negs[i])
        k_out = k_step(*carry, batches[i], batches[i + 1], negs[i])
        carry = k_out[:-1]
        k_m, p_m = k_out[-1], p_out[-1]
        k_mu = tree_leaves(k_out[1]["mu"])
        p_mu = tree_leaves(p_out[1]["mu"])
        # (the first pipelined step's moments are all 0: the snapshot and
        # the rings are empty and the coherence term has no gradient at a
        # zero memory)
        top = max(max(amax(b) for b in p_mu), 1e-30)
        memory = rel(k_out[2]["memory"].mem, p_out[2]["memory"].mem, 1.0)
        if cfg.pipeline_depth:
            memory = max(memory, rel(k_out[3].read_mem, p_out[3].read_mem,
                                     1.0))
        got = {"loss": rel(k_m["loss"], p_m["loss"], 0.0),
               "logits": max(rel(k_m[k], p_m[k], 1.0)
                             for k in ("logit_p", "logit_n")),
               "memory": memory,
               "moments": max(amax(a - b) for a, b in zip(k_mu, p_mu)) / top}
        for k, v in got.items():
            worst[k] = max(worst[k], v)
        for name, a, b in zip(names, k_mu, p_mu):
            if amax(a) or amax(b):
                r = rel(a, b, 1e-30)
                if r > worst["moments_leaf"]:
                    worst["moments_leaf"], worst["worst_leaf"] = r, name
    return worst


def _leaf_names(tree, path=""):
    """'/'-joined key paths of the leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{path}/{k}")]
    return [path]


def train_phase(label, cfg, train_s, val_s, dst_range, dev, *, batch_size,
                n_batches, expect, oracle_steps=None, capture=(),
                profile=0, against=None, noise_floor=False):
    """Train one epoch of `n_batches` temporal batches (then evaluate on
    `val_s` unless it is None) through the kernels, counting launches;
    then the same from the same start and negatives through the plain
    versions (or through `against`, the config of another route), for all
    steps or the first `oracle_steps`, and compare. With `noise_floor`
    the free-running first losses and AP gaps are held to their limits
    plus the plain route's own spread when its table is perturbed at
    the size of a kernel's rounding (`_nudged_gaps`). The
    memory stage's kernel (`memory_stage_kernel`) must launch exactly once
    a train and an evaluation step, and on the pipelined schedule
    (cfg.pipeline_depth >= 1) `pres_predict` once a train step. Returns
    (launch counts, the largest inputs of the kernels in `capture`,
    summary)."""
    import numpy as np
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw

    batches = train_s.temporal_batches(batch_size, dev)[:n_batches]
    steps = len(batches) - 1
    gen = torch.Generator(dev).manual_seed(0)
    negs = [sample_negatives(gen, b, *dst_range) for b in batches[1:]]
    val = None
    if val_s is not None:
        vb = val_s.temporal_batches(batch_size, dev)
        val = (vb, [sample_negatives(gen, b, *dst_range) for b in vb[1:]])
    opt = adamw(1e-3)
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    start = (params, opt.init(params), mdgnn.init_state(cfg, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # gru_cell's inputs are copied when a larger one arrives, in practice
    # at the first step only, which events/s and the median step leave out
    with Capture(names=[n for n in capture if n == "gru_cell"],
                 latest=False) as cap:
        losses, secs, res, ev, state, params_f = _run_train(
            cfg, opt, start, batches, steps, negs, val, dst_range, True)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    inputs = dict(cap.best)
    inputs.update(_probe(cfg, capture, params_f, state, batches[-1],
                         negs[-1]))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check_launches(label, counts, expect)
    stage = memory_stage_kernel(cfg)
    calls = steps + (len(val[0]) - 1 if val is not None else 0)
    require(stage is None or counts[stage] == calls,
            f"{label}: {stage} launched {counts.get(stage)} times in {calls} "
            f"train and evaluation steps")
    if cfg.pipeline_depth:
        require(counts["pres_predict"] == steps,
                f"{label}: pres_predict launched {counts['pres_predict']} "
                f"times in {steps} pipelined steps")
    require(np.isfinite(losses).all() and len(losses) == steps,
            f"{label}: bad losses {losses}")
    require(bool(torch.isfinite(state["memory"].mem).all()),
            f"{label}: memory table not finite")
    require(0.0 <= res.ap <= 1.0, f"{label}: train AP out of range")
    # the first step pays one-time costs (cuBLAS handles, autograd's first
    # backward, the allocator): reported apart, and left out of events/s
    summary = {"steps": steps, "batch": batch_size,
               "first_step_ms": secs[0] * 1e3,
               "step_ms_median": float(np.median(secs[1:])) * 1e3,
               "train_events_per_s": (steps - 1) * batch_size
               / sum(secs[1:]), "loss": res.loss,
               "train_ap": res.ap, "peak_mem_mb": peak_mb,
               "first_losses": losses[:3]}
    if ev is not None:
        summary.update(val_ap=ev[0], val_auc=ev[1])
    log(f"[{label}] {json.dumps(summary)}")

    # free-running: the same epoch from the same start and negatives
    # through the kernels again and through the plain versions. Their
    # rounding differences (1e-7) grow from step to step through training
    # (AdamW turns a near-zero gradient's rounding into a whole update), so
    # past the first steps this bounds the outcome, not the arithmetic.
    # Both runs use deterministic algorithms: with sums in atomic order the
    # gap itself varied from run to run (val AP 0.004-0.022 on the H100)
    o_cfg = against or dataclasses.replace(cfg, kernels_mode="oracle")
    n_free = oracle_steps or steps
    free_val = val if oracle_steps is None else None
    with _deterministic():
        k_losses, _, k_res, k_ev, k_state, _ = _run_train(
            cfg, opt, start, batches, n_free, negs, free_val, dst_range,
            False)
        o_losses, _, o_res, o_ev, o_state, _ = _run_train(
            o_cfg, opt, start, batches, n_free, negs, free_val, dst_range,
            False)
        # teacher-forced: every step from the same state, held tightly
        per_step = (_step_vs_plain(cfg, opt, start, batches, negs, steps,
                                   o_cfg)
                    if oracle_steps is None else None)
        floor = (_nudged_gaps(o_cfg, opt, start, batches, n_free, negs,
                              free_val, dst_range, o_losses, o_res, o_ev)
                 if noise_floor else {})
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(k_losses, o_losses)]
    diff = {"loss_rel_by_step": rel}
    if oracle_steps is None:
        diff.update(train_ap=abs(k_res.ap - o_res.ap),
                    memory_table=float((k_state["memory"].mem
                                        - o_state["memory"].mem).abs().max()))
        if k_ev is not None:
            diff["val_ap"] = abs(k_ev[0] - o_ev[0])
        diff["per_step"] = per_step
    if floor:
        diff["noise_floor"] = floor
    other = "the kernel route" if against else "the plain path"
    log(f"[{label}] vs {other}: {json.dumps(diff)}")
    require(max(rel[:3]) <= 1e-4 + floor.get("first_losses", 0.0),
            f"{label}: first losses {k_losses[:3]} vs {other} "
            f"{o_losses[:3]}")
    for k in ("train_ap", "val_ap"):
        lim = AP_LIMIT + floor.get(k, 0.0)
        require(diff.get(k, 0.0) <= lim, f"{label}: {k} differs from "
                f"{other}'s by {diff.get(k)} > {lim}")
    for k, lim in STEP_TOL.items():
        got = diff.get("per_step", {}).get(k, 0.0)
        require(got <= lim, f"{label}: a step's {k} differs from {other}'s "
                f"step by {got:.3g} (relative) > {lim}")
    summary["vs_plain"] = diff
    if profile:
        DEFERRED_PROFILES.append(functools.partial(
            _profile_train, label, cfg, opt, start, batches, negs,
            min(profile, steps - 1)))
    return counts, inputs, summary


@contextlib.contextmanager
def _nudge_table(eps):
    """Every memory stage (train and evaluation) adds eps * max(1, |x|) *
    r to each entry x of the table after it writes it, r a fixed pattern
    of random signs (seed 0): a perturbation of the form, and at eps =
    1e-6 about the size, of a kernel's difference from its plain version
    (`TOL`, and the per-step memory differences the train phases log)."""
    import torch
    from repro_torch.train import loop
    stage = loop.memory_and_pres
    signs = {}

    def nudged(*a, **kw):
        out = stage(*a, **kw)
        with torch.no_grad():
            mem = out[0].mem
            if "r" not in signs:
                gen = torch.Generator(mem.device).manual_seed(0)
                signs["r"] = torch.randint(
                    0, 2, mem.shape, generator=gen, device=mem.device,
                    dtype=mem.dtype) * 2 - 1
            mem.add_(eps * torch.clamp(mem.abs(), min=1.0) * signs["r"])
        return out

    loop.memory_and_pres = nudged
    try:
        yield
    finally:
        loop.memory_and_pres = stage


def _nudged_gaps(cfg, opt, start, batches, steps, negs, val, dst_range,
                 losses, res, ev):
    """The plain route's own free-running spread: the largest relative gap
    of its first 3 losses, and its train and val AP gaps, to `losses`,
    `res` and `ev` (its unperturbed run) when every memory stage perturbs
    the table by +-1e-7 and +-1e-6 of its scale (`_nudge_table`); the
    largest of the four runs for each. A model that this spread already
    moves by more than the free-running limits (JODIE's raw-time
    projection, ROADMAP R7) cannot be held to those limits alone."""
    gaps = {"first_losses": 0.0, "train_ap": 0.0, "val_ap": 0.0}
    for eps in (1e-7, -1e-7, 1e-6, -1e-6):
        with _nudge_table(eps):
            n_losses, _, n_res, n_ev, _, _ = _run_train(
                cfg, opt, start, batches, steps, negs, val, dst_range, False)
        gaps["first_losses"] = max([gaps["first_losses"]] + [
            abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(n_losses[:3], losses[:3])])
        gaps["train_ap"] = max(gaps["train_ap"], abs(n_res.ap - res.ap))
        if ev is not None:
            gaps["val_ap"] = max(gaps["val_ap"], abs(n_ev[0] - ev[0]))
    return gaps


def _probe(cfg, names, params, state, batch, neg):
    """Inputs of `names` other than gru_cell from one more call of the
    path on the trained state, made after the counters were read: the
    embedding of the last step's endpoints (neighbor_attn; at the first
    step the rings are still empty), the staleness fill with one batch in
    flight (pres_predict), and the memory stage on a copy of the state
    (pres_filter; for memory_update, the rows `memory_update_table` gathers
    and the rest of its inputs: the dense op on the same occurrences)."""
    import torch
    from repro_torch.kernels import autodiff
    from repro_torch.models import mdgnn
    from repro_torch.train import loop, pipeline
    names = [n for n in names if n != "gru_cell"]
    if not names:
        return {}
    wrap = set(names)
    if "memory_update" in names:
        wrap.add("memory_update_table")
    with torch.no_grad(), Capture(names=wrap) as cap:
        if "pres_predict" in names:
            ps = pipeline.PipelineState.init(state["memory"])
            nodes = torch.cat([batch.src, batch.dst])
            ps.pending.index_add_(0, nodes, torch.cat(
                [batch.mask, batch.mask]).float())
            pipeline.stale_read_table(cfg, state["pres"], ps,
                                      state["memory"].last_update)
        if "neighbor_attn" in names:
            loop.endpoint_logits(params, cfg, state, batch, neg)
        if {"pres_filter", "memory_update"} & wrap:
            loop.memory_and_pres(params, cfg, mdgnn.clone_state(state),
                                 batch)
        torch.cuda.synchronize()
    best = dict(cap.best)
    if "memory_update" in names:
        _, a, kw = best.pop("memory_update_table")
        table, _, x, gidx, _, _, w, u, b, dm, scale, gamma = a
        best["memory_update"] = (x.shape[0], [
            x, autodiff.gather_rows(table, gidx), w, u, b, dm, scale, gamma],
            kw)
    return best


def cli_phase(label, argv, expect):
    """`python -m repro_torch.launch.train` with `argv` on the card (its
    default device), one epoch; its epoch line is printed by the CLI."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    ops.reset_launch_counts()
    hist = train_cli.main(argv)
    check_launches(label, ops.launch_counts(), expect)
    h = hist[-1]
    require(len(hist) == 1 and np.isfinite(h["loss"])
            and 0.0 <= h["val_ap"] <= 1.0, f"{label}: bad history {hist}")
    return h


def parity_phase(label, cfg, stream, dst_range, dev):
    """serve/parity.py's gate on the card: the captured engine against
    `loop.make_eval_step` in lock step over `stream` (buckets 16 and 64),
    within the JAX gate's 1e-5, each key prepared once."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.serve import MicroBatcher, check_offline_parity
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    state = mdgnn.init_state(cfg, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    max_diff, n_scored, eng = check_offline_parity(
        cfg, params, state, stream, dst_range, device=dev,
        batcher=MicroBatcher(buckets=(16, 64), d_edge=cfg.d_edge))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"[{label}] {len(stream)} events, {n_scored} pairs scored: "
        f"max|engine - eval_step| = {max_diff:.3g} ({secs:.1f}s)")
    graphs = check_captured(label, eng, kinds=("ingest", "query"))
    check_launches(label, counts, ("memory_update_table", "embed_attn"))
    require(n_scored > 1000, f"{label}: only {n_scored} pairs scored")
    require(max_diff < 1e-5, f"{label}: serve/evaluate drift {max_diff}")
    require(("ingest", 64) in graphs, f"{label}: the fold was not captured")
    return {"max_diff": max_diff, "n_scored": n_scored, "seconds": secs,
            "trace_counts": {" ".join(map(str, key)): c for key, c
                             in eng.trace_counts.items()}}


def cli_ckpt_phase(label, cfg, stream, dst_range, dev, expect):
    """The train CLI with --checkpoint (one epoch on the card), then the
    serve CLI with --checkpoint on the file; then an engine restored by
    `ServeEngine.from_checkpoint` against one built from the trainer's own
    params and state (kept when it saved): the same query scores within
    TOL."""
    import tempfile
    import numpy as np
    from repro_torch import bridge
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import mdgnn
    from repro_torch.serve import ServeEngine
    kept = {}
    bundle = bridge.mdgnn_bundle

    def keep(params, state):
        kept.update(params=params, state=mdgnn.clone_state(state))
        return bundle(params, state)
    model = ["--dataset", "wiki-small", "--model", "tgn", "--pres",
             "--use-kernels"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "wiki.ckpt")
        bridge.mdgnn_bundle = keep
        try:
            ops.reset_launch_counts()
            hist = train_cli.main(model + ["--epochs", "1", "--checkpoint",
                                           path])
        finally:
            bridge.mdgnn_bundle = bundle
        check_launches(f"{label}-train", ops.launch_counts(), expect)
        require(pathlib.Path(path).is_file() and "params" in kept,
                f"{label}: no checkpoint written")
        ops.reset_launch_counts()
        rep = serve_cli.main(model + ["--checkpoint", path, "--max-events",
                                      "2000", "--topk", "5"])
        check_launches(f"{label}-serve", ops.launch_counts(), SERVE_KERNELS)
        require(not rep.post_warmup_traces and 0.0 <= rep.online_ap <= 1.0,
                f"{label}: serve CLI report {rep}")
        restored = ServeEngine.from_checkpoint(path, cfg, device=dev,
                                               item_range=dst_range)
    live = ServeEngine(cfg, kept["params"], kept["state"], device=dev,
                       item_range=dst_range)
    q = slice(0, 512)
    t = np.full(512, stream.t[-1], np.float32)
    got = restored.query(stream.src[q], stream.dst[q], t)
    want = live.query(stream.src[q], stream.dst[q], t)
    err = float(np.abs(got - want).max())
    log(f"[{label}] restored vs in-memory engine: max|query diff| "
        f"{err:.3g}; serve CLI AP {rep.online_ap:.4f}")
    require(np.isfinite(got).all()
            and err <= TOL["embed_attn"] * max(1.0, float(np.abs(want).max())),
            f"{label}: restored scores differ by {err}")
    return {"train": hist[-1], "serve_ap": rep.online_ap,
            "restored_vs_live": err}


def cli_csv_phase(label, expect):
    """The train CLI with --csv on the checked-in mini csv, one epoch on
    the card; its validation split is one event, so val AP is nan."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    ops.reset_launch_counts()
    hist = train_cli.main(["--csv", str(ROOT / "tests" / "data" /
                                        "mini_jodie.csv"),
                           "--model", "tgn", "--pres", "--use-kernels",
                           "--batch-size", "2", "--epochs", "1"])
    check_launches(label, ops.launch_counts(), expect)
    require(len(hist) == 1 and np.isfinite(hist[0]["loss"]),
            f"{label}: bad history {hist}")
    return hist[0]


# ---------------------------------------------------------------------------
# phase 11: scan macro-batch training, the event store, telemetry, autotune
# ---------------------------------------------------------------------------


def _epoch(engine, cfg, opt, carry, batches, gen, dst_range):
    """One epoch from `carry` through the scan engine, or, when `engine`
    is None, through the lag-one loop of `cfg`; device-synced seconds."""
    import torch
    from repro_torch.train import loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if engine is None:
        out = loop.run_epoch(*carry, batches, cfg,
                             loop.make_train_step(cfg, opt), gen, dst_range)
    else:
        out = engine.run_epoch(*carry, batches, gen, dst_range)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _macro_vs_lag_one(cfg, opt, dst_range, worst):
    """A step hook for ScanEngine: before each macro step, the same T
    steps through the lag-one step of `cfg` from copies of the carry and
    of the generator; after it, the worst relative difference of the
    losses, the logits, the memory table and the first moments goes into
    `worst` (macro by macro: no difference is carried to the next)."""
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.train import loop
    from repro_torch.utils.tree import tree_leaves
    step = loop.make_train_step(cfg, opt)
    amax = lambda t: float(t.abs().max())
    rel = lambda a, b, floor: amax(a - b) / max(floor, amax(b))

    def hook(macro_step):
        def run(params, opt_state, state, gen, macro, negatives=None):
            carry = _clone(params, opt_state, state)
            g = torch.Generator(gen.device)
            g.set_state(gen.get_state())
            lag = []
            for i in range(macro.src.shape[0] - 1):
                pos = macro.at(i + 1)
                neg = sample_negatives(g, pos, *dst_range)
                out = step(*carry, macro.at(i), pos, neg)
                carry = out[:-1]
                lag.append(out[-1])
            out = macro_step(params, opt_state, state, gen, macro,
                             negatives=negatives)
            m = out[-1]
            got = {"loss": rel(m["loss"], torch.stack(
                       [x["loss"] for x in lag]), 0.0),
                   "logits": max(rel(m[k], torch.stack(
                       [x[k] for x in lag]), 1.0)
                       for k in ("logit_p", "logit_n")),
                   "memory": rel(out[2]["memory"].mem,
                                 carry[2]["memory"].mem, 1.0),
                   "moments": max(amax(a - b) for a, b in zip(
                       tree_leaves(out[1]["mu"]),
                       tree_leaves(carry[1]["mu"]))) / max(
                       max(amax(b) for b in tree_leaves(carry[1]["mu"])),
                       1e-30)}
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
            return out
        return run
    return hook


def scan_phase(label, cfg, train_s, val_s, dst_range, dev, *, batch_size,
               expect, captured, chunk=8, windows=None):
    """Macro-batch training (train/scan.py, T = `chunk`) for one epoch and
    `evaluate` at `cfg`'s widths, against the lag-one loop from the same
    start and the same generator: the launch counts equal (the graph's
    replays add their census), the negatives of the captured and of an
    eager (capture=False) scan equal the lag-one loop's draws, and under
    deterministic algorithms the epoch free-running and every macro from
    the same carry (`_macro_vs_lag_one`) within STEP_TOL, and the epoch
    against the plain versions (kernels_mode="oracle") within the
    free-running limits. `ScanEngine.captured` must be `captured`. Then a
    second epoch of each, timed (events/s); `windows` gets one more epoch
    of each for `_profile_windows` (the busy share)."""
    import numpy as np
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.train import loop, scan

    scfg = dataclasses.replace(cfg, scan_chunk=chunk)
    batches = train_s.temporal_batches(batch_size, dev)
    vb = val_s.temporal_batches(batch_size, dev)
    steps = len(batches) - 1
    opt = adamw(1e-3)
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    start = (params, opt.init(params), mdgnn.init_state(cfg, dev))
    gen = lambda: torch.Generator(dev).manual_seed(0)
    eval_step = loop.make_eval_step(cfg)
    runs = {}
    for name, engine in (("scan", scan.ScanEngine(scfg, opt)),
                         ("lag-one", None)):
        g = gen()
        ops.reset_launch_counts()
        (p, o, s, res), secs = _epoch(engine, cfg, opt, _clone(*start),
                                      batches, g, dst_range)
        _, vap, _ = loop.evaluate(p, s, vb, cfg, eval_step, g, dst_range)
        counts = ops.launch_counts()
        kept = list(engine.negatives) if engine is not None else None
        (p, o, s, res2), secs2 = _epoch(engine, cfg, opt, (p, o, s),
                                        batches, g, dst_range)
        runs[name] = {"counts": counts, "res": res, "val_ap": vap,
                      "first_epoch_s": secs, "epoch_s": secs2,
                      "carry": (p, o, s), "engine": engine, "gen": g,
                      "negatives": kept}
    eng = runs["scan"]["engine"]
    check_launches(label, runs["scan"]["counts"], expect)
    require(runs["scan"]["counts"] == runs["lag-one"]["counts"],
            f"{label}: launches {runs['scan']['counts']} against the "
            f"lag-one loop's {runs['lag-one']['counts']}")
    require(eng.captured is captured,
            f"{label}: ScanEngine.captured is {eng.captured}, expected "
            f"{captured} ({eng.eager_reason})")
    # the negatives of the first epoch: the lag-one loop's draws, in
    # order, in the captured engine and in an eager one
    g = gen()
    want = torch.stack([sample_negatives(g, b, *dst_range).dst
                        for b in batches[1:]])
    eager = scan.ScanEngine(scfg, opt, capture=False)
    eager.run_epoch(*_clone(*start), batches, gen(), dst_range)
    got = torch.cat(runs["scan"]["negatives"])
    require(torch.equal(got, want)
            and torch.equal(torch.cat(eager.negatives), want),
            f"{label}: the scan's negatives differ from the lag-one draws")
    # deterministic comparisons
    worst = {}
    with _deterministic():
        free = {}
        for name, c, engine in (
                ("scan", cfg, scan.ScanEngine(scfg, opt)),
                ("lag-one", cfg, None),
                ("plain", dataclasses.replace(cfg, kernels_mode="oracle"),
                 None)):
            g = gen()
            (p, o, s, res), _ = _epoch(engine, c, opt, _clone(*start),
                                       batches, g, dst_range)
            _, vap, _ = loop.evaluate(p, s, vb, c, loop.make_eval_step(c), g,
                                      dst_range)
            free[name] = (res, vap, s["memory"].mem)
        macro = scan.ScanEngine(scfg, opt, step_hook=_macro_vs_lag_one(
            cfg, opt, dst_range, worst))
        _epoch(macro, cfg, opt, _clone(*start), batches, gen(), dst_range)
    rel = lambda a, b: [abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b)]
    diff = {}
    for other in ("lag-one", "plain"):
        r, vap, mem = free[other]
        diff[other] = {
            "loss_rel": max(rel([free["scan"][0].loss], [r.loss])),
            "train_ap": abs(free["scan"][0].ap - r.ap),
            "val_ap": abs(free["scan"][1] - vap),
            "memory_table": float((free["scan"][2] - mem).abs().max())}
    diff["per_macro"] = worst
    log(f"[{label}] vs the lag-one loop and the plain path: "
        f"{json.dumps(diff)}")
    for k, lim in STEP_TOL.items():
        require(worst.get(k, 0.0) <= lim, f"{label}: a macro's {k} differs "
                f"from the lag-one steps' by {worst.get(k)} > {lim}")
    for other in ("lag-one", "plain"):
        for k in ("train_ap", "val_ap"):
            require(diff[other][k] <= AP_LIMIT, f"{label}: {k} differs from "
                    f"the {other} run's by {diff[other][k]} > {AP_LIMIT}")
    require(diff["lag-one"]["loss_rel"] <= STEP_TOL["loss"],
            f"{label}: epoch loss differs from the lag-one loop's")
    summary = {"steps": steps, "batch": batch_size, "chunk": chunk,
               "captured": eng.captured, "eager_reason": eng.eager_reason,
               "loss": runs["scan"]["res"].loss,
               "train_ap": runs["scan"]["res"].ap,
               "val_ap": runs["scan"]["val_ap"], "vs": diff}
    for name, r in runs.items():
        summary[f"{name}_first_epoch_s"] = r["first_epoch_s"]
        summary[f"{name}_events_per_s"] = steps * batch_size / r["epoch_s"]
        summary[f"{name}_step_ms"] = r["epoch_s"] / steps * 1e3
    for name, r in runs.items():
        if windows is not None:
            windows.append((f"{label}-{name}", functools.partial(
                _epoch, r["engine"], cfg, opt, r["carry"], batches,
                r["gen"], dst_range), f"one epoch ({steps} steps)"))
    brief = {k: v for k, v in summary.items() if k != "vs"}
    log(f"[{label}] {json.dumps(brief)}")
    require(np.isfinite(summary["loss"]), f"{label}: loss not finite")
    return summary


def production_scan_phase(label, cfg, train_s, dst_range, dev, *,
                          batch_size, n_batches, expect, chunk=8):
    """Macro-batch training at PRODUCTION widths: `n_batches - 1` steps at
    `batch_size`, captured, a first run (it captures) and a second, timed
    (step ms); the first 3 losses against the lag-one loop's kernel route
    from the same start and generator."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.train import loop, scan
    cfg = dataclasses.replace(cfg, obs_metrics=True)
    scfg = dataclasses.replace(cfg, scan_chunk=chunk)
    batches = train_s.temporal_batches(batch_size, dev)[:n_batches]
    steps = len(batches) - 1
    opt = adamw(1e-3)
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    start = (params, opt.init(params), mdgnn.init_state(cfg, dev))
    eng = scan.ScanEngine(scfg, opt)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    g = torch.Generator(dev).manual_seed(0)
    (p, o, s, res), first = _epoch(eng, cfg, opt, _clone(*start), batches, g,
                                   dst_range)
    counts = ops.launch_counts()
    check_launches(label, counts, expect)
    require(counts[memory_stage_kernel(cfg)] == steps and eng.captured,
            f"{label}: {counts} in {steps} steps, captured {eng.captured}")
    (_, _, _, res2), secs = _epoch(eng, cfg, opt, (p, o, s), batches, g,
                                   dst_range)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    lag = loop.run_epoch(*_clone(*start), batches[:4], cfg,
                         loop.make_train_step(cfg, opt),
                         torch.Generator(dev).manual_seed(0), dst_range)[-1]
    got, want = res.obs["series"]["loss"][:3], lag.obs["series"]["loss"]
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want)]
    summary = {"steps": steps, "batch": batch_size, "chunk": chunk,
               "captured": eng.captured, "first_run_s": first,
               "step_ms": secs / steps * 1e3,
               "train_events_per_s": steps * batch_size / secs,
               "loss": res.loss, "peak_mem_mb": peak_mb,
               "first_losses": got, "lag_one_first_losses": want}
    log(f"[{label}] {json.dumps(summary)}")
    require(np.isfinite(res.loss) and np.isfinite(res2.loss)
            and max(rel) <= 1e-4, f"{label}: first losses {got} against "
            f"the lag-one loop's {want}")
    return summary


def store_phase(label, cfg, dev, *, n_events, batch_size, n_batches,
                expect):
    """tgn_pres.PRODUCTION over an on-disk store of stream-10m's first
    `n_events` events (its 1,200,000-node space), written by the port's
    converter into a temporary directory: the store's first batches
    against the same events carved in RAM (bit for bit), then
    `train_phase` on the store's batches (the first 3 losses against the
    plain path, step ms, peak memory)."""
    import tempfile
    import torch
    from repro_torch.graph.store import EventStore
    from repro_torch.launch import convert_events
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        convert_events.main(["--synthetic", "stream-10m", "--n-events",
                             str(n_events), "--out", tmp])
        wrote = time.perf_counter() - t0
        est = EventStore.open(tmp)
        c = dataclasses.replace(cfg, n_nodes=est.num_nodes,
                                d_edge=est.feat_dim, event_store=tmp)
        head = est.stream().slice(0, batch_size * n_batches)
        ram = head.materialize()
        carve = {}
        for name, src in (("store", head), ("ram", ram)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carve[name] = src.temporal_batches(batch_size, dev)
            torch.cuda.synchronize()
            carve[f"{name}_ms_a_batch"] = ((time.perf_counter() - t0) * 1e3
                                           / len(carve[name]))
        for a, b in zip(carve.pop("store"), carve.pop("ram")):
            require(all(torch.equal(getattr(a, f), getattr(b, f))
                        for f in ("src", "dst", "t", "feat", "mask")),
                    f"{label}: a store batch differs from the in-RAM one")
        log(f"[{label}] carving a batch: {json.dumps(carve)}")
        counts, _, summary = train_phase(
            label, c, head, None, est.dst_range(), dev,
            batch_size=batch_size, n_batches=n_batches, expect=expect,
            oracle_steps=3)
        summary.update(n_nodes=est.num_nodes, d_edge=est.feat_dim,
                       store_mb=est.nbytes / 1e6, write_s=wrote, **carve)
    return summary


def _shard_run(cfg, n, dev, opt, batches, negs, val, dst_range, engine):
    """One epoch at `n` shards (all on `dev`) from the seed's parameters
    and a fresh state, then `evaluate`; returns (per-step losses,
    EpochResult, (val AP, val AUC), natural-layout state, launch counts,
    seconds, scan engine or None). The scan engine draws its negatives in
    the step from a generator seeded as the loop's draws were (the same
    draws)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.train import loop, pipeline, routing, scan
    c = dataclasses.replace(cfg, n_shards=n)
    params = mdgnn.init_params(c, torch.Generator().manual_seed(0), dev)
    state = mdgnn.init_state(c, dev)
    if n > 1:
        state = routing.shard_state(c, state, routing.get_mesh(n, dev))
    losses = []

    def recorded(step):
        def run(*a, **kw):
            out = step(*a, **kw)
            losses.append(out[-1]["loss"])
            return out
        return run

    eng = None
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if engine == "scan":
        eng = scan.ScanEngine(c, opt, step_hook=recorded)
        params, _, state, res = eng.run_epoch(
            params, opt.init(params), state, batches,
            torch.Generator(dev).manual_seed(0), dst_range)
    else:
        params, _, state, res = pipeline.run_epoch(
            params, opt.init(params), state, batches, c,
            recorded(pipeline.make_train_step(c, opt)), None, dst_range,
            negatives=negs)
    _, vap, vauc = loop.evaluate(params, state, val[0], c,
                                 loop.make_eval_step(c), None, dst_range,
                                 negatives=val[1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    if n > 1:
        state = routing.unshard_state(c, state)
    losses = [float(x) for x in torch.cat([x.reshape(-1) for x in losses])]
    return losses, res, (vap, vauc), state, counts, secs, eng


def _natural_step(cfg, opt, mesh):
    """The train step of sharded `cfg` on a natural-layout carry: the
    state sharded on `mesh` before the step, unsharded after it."""
    from repro_torch.train import pipeline, routing
    step = pipeline.make_train_step(cfg, opt)

    def run(params, opt_state, state, *rest):
        out = step(params, opt_state,
                   routing.shard_state(cfg, state, mesh), *rest)
        return out[:2] + (routing.unshard_state(cfg, out[2]),) + out[3:]

    return run


def _overflow_on_cpu(batches, n, budget, n_nodes):
    """The routing plan's overflow of `batches` (each a step's memory-stage
    batch) at `n` shards and `budget`, computed on the CPU."""
    import torch
    from repro_torch.train import routing
    total = 0
    for b in batches:
        cb = routing.place_batch(b, torch.device("cpu"))
        nodes, _, _, _, mask, _, _ = routing._padded_occurrences(cb, n)
        ms = nodes.shape[0] // n
        for s in range(n):
            sl = slice(s * ms, (s + 1) * ms)
            total += int(routing.bucket_plan(
                nodes[sl].clamp(0, n_nodes - 1) % n, mask[sl], n,
                budget)[3])
    return total


def shard_phase(label, cfg, train_s, val_s, dst_range, dev, *, batch_size,
                shards, expect, engine="loop", noise_floor=False,
                budget=None):
    """Memory-parallel training at CONFIG widths, every shard on `dev`,
    under deterministic algorithms: one epoch + evaluate at each shard
    count of `shards` (the first 1) from the same parameters, state and
    negatives, the path's kernels launched and no other, the memory
    stage's kernel n times a step (memory_update_table; once for the cell
    kernels), on the pipelined schedule pres_predict once a step, the scan
    engine captured on the card. Each shard count is held to
    one shard's run as the train phases hold two routes: every step from
    the SAME carry (the n = 1 run's, sharded for the step and unsharded
    after it) within STEP_TOL (loss and memory table 1e-5; not for the
    scan engine, whose macro runs that step body), and free-running the
    first 3 losses within 1e-5 and the train and val AP within AP_LIMIT
    (with `noise_floor` plus the n = 1 run's own spread under a
    rounding-sized nudge of its table, `_nudge_table`): the shards' sums
    run in another order (each shard's backward through the plain
    version sums its own rows), and such 1e-7 differences grow through
    AdamW from step to step (on this path on the CPU: 2e-6 of the table
    after 8 steps, 1e-3 after 16, 0.17 after 27). With `budget` a last
    run at the largest shard count and that budget: its route_overflow
    equals the plan of the same batches on the CPU."""
    import numpy as np
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.train import routing, scan
    batches = train_s.temporal_batches(batch_size, dev)
    steps = len(batches) - 1
    gen = torch.Generator(dev).manual_seed(0)
    negs = [sample_negatives(gen, b, *dst_range) for b in batches[1:]]
    vb = val_s.temporal_batches(batch_size, dev)
    val = (vb, [sample_negatives(gen, b, *dst_range) for b in vb[1:]])
    opt = adamw(1e-3)
    stage = memory_stage_kernel(cfg)
    calls = steps + len(vb) - 1
    runs, summary = {}, {"steps": steps, "batch": batch_size}
    with _deterministic():
        for n in shards:
            losses, res, ev, state, counts, secs, eng = _shard_run(
                cfg, n, dev, opt, batches, negs, val, dst_range, engine)
            check_launches(f"{label}-{n}", counts, expect)
            if stage is not None:
                per = n if stage == "memory_update_table" else 1
                require(counts[stage] == per * calls,
                        f"{label}-{n}: {stage} launched {counts[stage]} "
                        f"times in {calls} steps at {n} shards")
            if cfg.pipeline_depth:
                require(counts["pres_predict"] == steps,
                        f"{label}-{n}: pres_predict {counts['pres_predict']}")
            if eng is not None:
                require(eng.captured == (dev.type == "cuda"),
                        f"{label}-{n}: captured {eng.captured} on "
                        f"{dev.type} ({eng.eager_reason})")
            require(np.isfinite(losses).all() and len(losses) == steps
                    and res.route_overflow == 0,
                    f"{label}-{n}: losses {losses[:3]}.., overflow "
                    f"{res.route_overflow}")
            runs[n] = (losses, res, ev, state)
            summary[f"n{n}"] = {
                "train_ap": res.ap, "val_ap": ev[0], "loss": res.loss,
                "seconds": secs, "ms_per_step": secs / calls * 1e3,
                "launches": {k: v for k, v in counts.items() if v},
                "captured": None if eng is None else eng.captured}
        floor = {"first_losses": 0.0, "train_ap": 0.0, "val_ap": 0.0}
        if noise_floor:
            b_losses, b_res, b_ev, _ = runs[1]
            for eps in (1e-7, -1e-7, 1e-6, -1e-6):
                with _nudge_table(eps):
                    losses, res, ev, _, _, _, _ = _shard_run(
                        cfg, 1, dev, opt, batches, negs, val, dst_range,
                        engine)
                floor["first_losses"] = max([floor["first_losses"]] + [
                    abs(a - b) / max(abs(b), 1e-12)
                    for a, b in zip(losses[:3], b_losses[:3])])
                floor["train_ap"] = max(floor["train_ap"],
                                        abs(res.ap - b_res.ap))
                floor["val_ap"] = max(floor["val_ap"], abs(ev[0] - b_ev[0]))
            summary["noise_floor"] = floor
        per_step = {}
        if engine != "scan":
            one = dataclasses.replace(cfg, n_shards=1)
            params = mdgnn.init_params(one, torch.Generator().manual_seed(0),
                                       dev)
            start = (params, opt.init(params), mdgnn.init_state(one, dev))
            for n in shards[1:]:
                c = dataclasses.replace(cfg, n_shards=n)
                per_step[n] = _step_vs_plain(
                    one, opt, start, batches, negs, steps, one,
                    k_step=_natural_step(c, opt, routing.get_mesh(n, dev)))
        if budget is not None:
            n = max(shards)
            c = dataclasses.replace(cfg, shard_budget=budget)
            _, res, _, _, _, _, _ = _shard_run(c, n, dev, opt, batches,
                                               negs, val, dst_range, engine)
            want = _overflow_on_cpu(batches[:-1], n, budget, cfg.n_nodes)
            summary["tight_budget"] = {"n_shards": n, "budget": budget,
                                       "route_overflow": res.route_overflow,
                                       "cpu_plan": want}
            require(res.route_overflow == want > 0,
                    f"{label}: route_overflow {res.route_overflow} at budget "
                    f"{budget}, the CPU plan counts {want}")
    l1, res1, ev1, st1 = runs[1]
    for n in shards[1:]:
        losses, res, ev, st = runs[n]
        got = {"first_losses": max(abs(a - b) / max(abs(b), 1e-12)
                                   for a, b in zip(losses[:3], l1[:3])),
               "train_ap": abs(res.ap - res1.ap),
               "val_ap": abs(ev[0] - ev1[0])}
        lims = {"first_losses": STEP_TOL["loss"], "train_ap": AP_LIMIT,
                "val_ap": AP_LIMIT}
        table = float((st["memory"].mem - st1["memory"].mem).abs().max())
        summary[f"n{n}"]["vs_n1"] = dict(got, memory_table=table,
                                         per_step=per_step.get(n))
        for k, v in got.items():
            lim = lims[k] + floor[k]
            require(v <= lim, f"{label}: {k} at {n} shards differs from one "
                    f"shard's by {v:.3g} > {lim:.3g}")
        for k, lim in STEP_TOL.items():
            v = per_step.get(n, {}).get(k, 0.0)
            require(v <= lim, f"{label}: a step's {k} at {n} shards differs "
                    f"from one shard's step by {v:.3g} > {lim}")
    log(f"[{label}] {json.dumps(summary)}")
    return summary


def shard_production_phase(label, cfg, train_s, dst_range, dev, *,
                           batch_size, n_batches, n_shards, expect):
    """PRODUCTION widths at `n_shards` shards on `dev`: `n_batches - 1`
    steps at `batch_size` from the seed's parameters (the negatives drawn
    as train_phase draws them), step ms (device-synced, median past the
    first) and peak memory; memory_update_table n_shards times a step; the
    first 3 losses against the unsharded step's from the same start."""
    import numpy as np
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.train import loop, routing
    batches = train_s.temporal_batches(batch_size, dev)[:n_batches]
    steps = len(batches) - 1
    gen = torch.Generator(dev).manual_seed(0)
    negs = [sample_negatives(gen, b, *dst_range) for b in batches[1:]]
    opt = adamw(1e-3)
    c = dataclasses.replace(cfg, n_shards=n_shards)
    params = mdgnn.init_params(c, torch.Generator().manual_seed(0), dev)
    start = (params, opt.init(params), mdgnn.init_state(c, dev))
    carry = _clone(*start)
    carry = carry[:2] + (routing.shard_state(
        c, carry[2], routing.get_mesh(n_shards, dev)),)
    step = loop.make_train_step(c, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    secs, losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *carry, m = step(*carry, batches[i], batches[i + 1], negs[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check_launches(label, counts, expect)
    require(counts["memory_update_table"] == n_shards * steps,
            f"{label}: memory_update_table {counts['memory_update_table']} "
            f"times in {steps} steps at {n_shards} shards")
    losses = [float(x) for x in losses]
    one = dataclasses.replace(cfg, n_shards=1)
    carry1, want = _clone(*start), []
    step1 = loop.make_train_step(one, opt)
    for i in range(3):
        *carry1, m = step1(*carry1, batches[i], batches[i + 1], negs[i])
        want.append(float(m["loss"]))
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, want)]
    summary = {"steps": steps, "batch": batch_size, "n_shards": n_shards,
               "first_step_ms": secs[0] * 1e3,
               "step_ms_median": float(np.median(secs[1:])) * 1e3,
               "train_events_per_s": (steps - 1) * batch_size
               / sum(secs[1:]), "peak_mem_mb": peak_mb,
               "first_losses": losses[:3], "unsharded_first_losses": want}
    log(f"[{label}] {json.dumps(summary)}")
    require(np.isfinite(losses).all() and max(rel) <= 1e-4,
            f"{label}: first losses {losses[:3]} against the unsharded "
            f"step's {want}")
    return summary


def bf16_phase(label, cfg, train_s, dst_range, dev, *, batch_size,
               n_batches, expect):
    """A bfloat16 memory table (mem_dtype="bfloat16"): `n_batches - 1`
    train steps through the kernels, timed, the table kernel's bf16
    instantiation launched once a step; its largest inputs captured and
    the instantiation held against its plain version there (each written
    row within one bf16 ulp, s_meas / fused / delta within TOL, last_t
    exact). Returns (launch counts, captured inputs, summary)."""
    import numpy as np
    import torch
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.kernels import ops
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    c = dataclasses.replace(cfg, mem_dtype="bfloat16")
    batches = train_s.temporal_batches(batch_size, dev)
    if n_batches:
        batches = batches[:n_batches]
    steps = len(batches) - 1
    gen = torch.Generator(dev).manual_seed(0)
    negs = [sample_negatives(gen, b, *dst_range) for b in batches[1:]]
    opt = adamw(1e-3)
    params = mdgnn.init_params(c, torch.Generator().manual_seed(0), dev)
    carry = (params, opt.init(params), mdgnn.init_state(c, dev))
    step = loop.make_train_step(c, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    secs, losses = [], []
    with Capture(names=["memory_update_table"], latest=False) as cap:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *carry, m = step(*carry, batches[i], batches[i + 1], negs[i])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(m["loss"])
    counts = ops.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check_launches(label, counts, expect)
    require(counts["memory_update_table"] == steps,
            f"{label}: memory_update_table {counts['memory_update_table']} "
            f"times in {steps} steps")
    table = carry[2]["memory"].mem
    require(table.dtype == torch.bfloat16
            and bool(torch.isfinite(table.float()).all()),
            f"{label}: the table is {table.dtype}, or not finite")
    losses = [float(x) for x in losses]
    require(np.isfinite(losses).all(), f"{label}: losses {losses}")
    inputs = dict(cap.best)
    _, a, kw = inputs["memory_update_table"]
    require(a[0].dtype == torch.bfloat16, f"{label}: captured an fp32 table")
    err = check_kernel("memory_update_table", a, kw, f"{label} inputs")
    summary = {"steps": steps, "batch": batch_size,
               "first_step_ms": secs[0] * 1e3,
               "step_ms_median": float(np.median(secs[1:])) * 1e3,
               "peak_mem_mb": peak_mb, "loss_last": losses[-1],
               "table_max_abs_err": err,
               "shape": shape_of("memory_update_table", a)}
    log(f"[{label}] {json.dumps(summary)}")
    return counts, inputs, summary


@contextlib.contextmanager
def _nccl_group(dev):
    """An NCCL process group of world 1 on `dev` over an in-memory
    HashStore (no socket), destroyed when the block ends."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spec_step_pair(cfg, opt, spec, mesh, carry, args, kw=None):
    """One single-device kernel step (the lag-one or pipelined step, or
    for cfg.scan_chunk > 1 the eager macro step) on a clone of `carry`,
    then the spec's step applied through `apply_spec` on `carry` itself
    (it updates its arguments in place), the launch counters zeroed just
    before it and read just after. Returns (single outputs, the spec's
    outputs gathered whole, the spec's launch counts, its collective
    counts, each step's device-synced seconds)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import distributed as tdist
    from repro_torch.train import pipeline, scan
    kw = kw or {}
    if cfg.scan_chunk > 1:
        single = scan.make_macro_step(cfg, opt, (0, cfg.n_nodes))
    else:
        single = pipeline.make_train_step(cfg, opt)
    mine = _clone(*carry[:3], *carry[3:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_out = single(*mine, *args, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    with tdist.collective_log() as comm:
        d_out = tdist.apply_spec(spec, mesh, *carry, *args, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    full = tdist.full_tree(d_out)
    return (s_out, full, counts,
            {str(k): v for k, v in comm.get_comm_counts().items()},
            (t1 - t0, t2 - t1))


def spec_phase(label, cfg, train_s, dst_range, dev, *, batch_size, expect,
               strategy="gspmd", rules=None, steps=3, time_it=False):
    """The distributed train spec (train/distributed.py) on a 1x1
    DeviceMesh over an NCCL group of world 1: `steps` steps of the spec's
    step applied through `apply_spec`, each from the SAME carry as the
    single-device kernel step (the lag-one or pipelined step; for
    cfg.scan_chunk > 1 one macro step of that many steps against the
    eager macro step, the negatives injected into both), the loss, the
    logits and the memory table within STEP_TOL; the spec's step launches
    the path's kernels and no other, the memory stage's kernel once a
    step; DTensor's collective counts logged. Under deterministic
    algorithms, except with `time_it`: then the steps' device-synced ms,
    single-device and spec, side by side."""
    import numpy as np
    import torch
    from repro_torch.graph.events import stack_batches
    from repro_torch.graph.negatives import sample_negatives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import mdgnn
    from repro_torch.optim import adamw
    from repro_torch.train import distributed as tdist
    batches = train_s.temporal_batches(batch_size, dev)[:steps + 1]
    gen = torch.Generator(dev).manual_seed(0)
    negs = [sample_negatives(gen, b, *dst_range) for b in batches[1:]]
    opt = adamw(1e-3)
    params = mdgnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    carry = _carry(cfg, (params, opt.init(params), mdgnn.init_state(cfg,
                                                                     dev)))
    amax = lambda t: float(t.float().abs().max())
    rel = lambda a, b, floor: amax(a - b) / max(floor, amax(b))
    stage = memory_stage_kernel(cfg)
    worst = {"loss": 0.0, "logits": 0.0, "memory": 0.0}
    total, comms, secs = {}, [], []
    # DTensor's advice on merging the collectives of a 2-dim mesh and on
    # detaching the tensors it wraps: the same lines every step
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    # deterministic sums (the timed phase excepted): a macro step runs its
    # steps free, and atomic-order differences would grow through AdamW
    det = contextlib.nullcontext() if time_it else _deterministic()
    with _nccl_group(dev), det, warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*local_tensor.detach")
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cuda")
        spec = tdist.make_mdgnn_train_spec(cfg, batch_size, mesh, rules=rules,
                                           strategy=strategy)
        if cfg.scan_chunk > 1:
            calls = [((None, stack_batches(batches[:steps + 1])),
                      {"negatives": negs[:steps]})]
        else:
            calls = [((batches[i], batches[i + 1], negs[i]), {})
                     for i in range(steps)]
        for args, kw in calls:
            s_out, d_out, counts, comm, sec = _spec_step_pair(
                cfg, opt, spec, mesh, carry, args, kw)
            s_m, d_m = s_out[-1], d_out[-1]
            s_loss = s_m["loss"]
            got = {"loss": rel(d_m["losses"] if "losses" in d_m
                               else d_m["loss"], s_loss, 0.0),
                   "logits": max(rel(d_m[k], s_m[k], 1.0)
                                 for k in ("logit_p", "logit_n")),
                   "memory": rel(d_out[2]["memory"].mem,
                                 s_out[2]["memory"].mem, 1.0)}
            for k, v in got.items():
                worst[k] = max(worst[k], v)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            comms.append(comm)
            secs.append(sec)
            require(np.isfinite(s_loss.detach().cpu().numpy()).all(),
                    f"{label}: loss {s_loss}")
            carry = s_out[:-1]
    check_launches(label, total, expect)
    if stage is not None:
        require(total[stage] == steps, f"{label}: {stage} launched "
                f"{total[stage]} times in {steps} spec steps")
    for k, v in worst.items():
        require(v <= STEP_TOL[k], f"{label}: the spec's step differs from "
                f"the single-device step: {k} {v:.3g} > {STEP_TOL[k]}")
    summary = {"strategy": strategy, "steps": steps, "batch": batch_size,
               "vs_single_device": worst, "launches": total,
               "collectives": comms}
    log(f"[{label}] collectives {json.dumps(comms)}")
    if time_it:
        # past the first step (its first calls build DTensor's caches)
        one = [a for a, _ in secs[1:]] or [secs[0][0]]
        dis = [b for _, b in secs[1:]] or [secs[0][1]]
        summary.update(single_ms=float(np.median(one)) * 1e3,
                       spec_ms=float(np.median(dis)) * 1e3)
    log(f"[{label}] {json.dumps(summary)}")
    return summary


def cli_store_phase(label, expect):
    """Both CLIs with --event-store, on wiki-small converted by the port's
    converter (one epoch; a replay of 2,000 events)."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import convert_events
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    model = ["--model", "tgn", "--pres", "--use-kernels"]
    with tempfile.TemporaryDirectory() as tmp:
        convert_events.main(["--dataset", "wiki-small", "--out", tmp])
        hist = cli_phase(f"{label}-train", model + ["--event-store", tmp,
                                                    "--epochs", "1"], expect)
        ops.reset_launch_counts()
        rep = serve_cli.main(model + ["--event-store", tmp, "--max-events",
                                      "2000", "--topk", "5"])
        check_launches(f"{label}-serve", ops.launch_counts(), SERVE_KERNELS)
    require(not rep.post_warmup_traces and 0.0 <= rep.online_ap <= 1.0,
            f"{label}: serve CLI report {rep}")
    return {"train": hist, "serve_events_per_s": rep.events_per_sec,
            "serve_ap": rep.online_ap}


def cli_obs_phase(label, card, expect, serve_expect):
    """The train CLI with --metrics-out, --trace-dir, --trace-steps 4,
    --scan-chunk 8 and --event-store, then the serve CLI with
    --metrics-out and --topk: the manifest names the card and its power
    limit, every epoch's series has an entry a step, the kernel-dispatch
    table shows only "compiled" for the path's kernels, the spans and the
    histograms are there, and the trace directory holds a trace."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import convert_events
    from repro_torch.launch import serve as serve_cli
    from repro_torch.obs import sink
    model = ["--model", "tgn", "--pres", "--use-kernels"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        convert_events.main(["--dataset", "wiki-small", "--out",
                             str(tmp / "store")])
        ops.reset_dispatch_log()
        hist = cli_phase(f"{label}-train", model + [
            "--event-store", str(tmp / "store"), "--epochs", "1",
            "--scan-chunk", "8", "--metrics-out", str(tmp / "train.jsonl"),
            "--trace-dir", str(tmp / "trace"), "--trace-steps", "4"], expect)
        ops.reset_dispatch_log()
        ops.reset_launch_counts()
        serve_cli.main(["--dataset", "wiki-small"] + model + [
            "--max-events", "2000", "--topk", "5", "--metrics-out",
            str(tmp / "serve.jsonl")])
        check_launches(f"{label}-serve", ops.launch_counts(), serve_expect)
        train = sink.read_runlog(tmp / "train.jsonl")
        serve = sink.read_runlog(tmp / "serve.jsonl")
        trace = tmp / "trace" / "trace.json"
        trace_mb = trace.stat().st_size / 1e6 if trace.is_file() else 0.0
    kinds = lambda recs: {r["kind"]: r for r in recs}
    tr, sv = kinds(train), kinds(serve)
    for name, recs, want in (("train", tr, expect),
                             ("serve", sv, serve_expect)):
        require(recs["manifest"]["meta"].get("gpu") == card,
                f"{label}: the {name} manifest names "
                f"{recs['manifest']['meta'].get('gpu')!r}, not {card!r}")
        table = recs.get("kernel_dispatch", {}).get("table", {})
        require(sorted(table) == sorted(want)
                and all(set(m) == {"compiled"} for m in table.values()),
                f"{label}: the {name} kernel-dispatch table is {table}")
    require("spans" in tr and {"prefetch_wait", "store_window"}
            <= set(tr["spans"]["summary"]),
            f"{label}: the train run-log's spans are {tr.get('spans')}")
    ep = tr["epoch"]
    require(all(len(v) == ep["steps"] for v in ep["series"].values())
            and ep["steps"] > 0 and ep.get("scan_captured") is True,
            f"{label}: the epoch's series do not have one entry a step")
    rec = sv["serve"]
    require(sum(rec["ingest_hist"]["counts"]) == rec["ingest_hist"]["n"] > 0
            and sum(rec["query_hist"]["counts"]) == rec["query_hist"]["n"]
            > 0, f"{label}: the serve histograms are empty")
    require(trace_mb > 0, f"{label}: no trace written")
    out = {"train": hist, "steps": ep["steps"], "trace_mb": trace_mb,
           "train_spans": tr["spans"]["summary"],
           "ingest_p99_ms": rec["ingest_p99_ms"]}
    log(f"[{label}] {json.dumps(out)}")
    return out


def autotune_phase(label, dev):
    """Every registered kernel tuned at the shapes the model emits at
    CONFIG widths (kernels/autotune.py: train steps of each route, a
    top-k, reduced qwen3 and xlstm prefills) into a temporary cache; each
    entry's ms beside its plain version's (oracle_ms). Then a dispatch
    without a pinned mode resolves "compiled" from the cache."""
    import tempfile
    from repro_torch.kernels import autotune, ops
    saved = autotune.CACHE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        autotune.CACHE_DIR = pathlib.Path(tmp)
        ops.reset_execution_policy()
        try:
            shapes = autotune.emitted_shapes(dev)
            rows = autotune.sweep(dev, shapes=shapes)
            for r in rows:
                log(f"[{label}] {r['kernel']} {r['mode']} ms={r['ms']:.5f} "
                    f"oracle_ms={r.get('oracle_ms')} {r['sig']}")
            require(sorted({r["kernel"] for r in rows}) ==
                    sorted(ops.REGISTRY)
                    and all(r["mode"] == "compiled" for r in rows),
                    f"{label}: entries "
                    f"{[(r['kernel'], r['mode']) for r in rows]}")
            (name, _), (args, _) = next(iter(shapes.items()))
            mode = ops.resolve_mode(None, dev, name, args)
            require(autotune.lookup("cuda", name, args) is not None
                    and mode == "compiled",
                    f"{label}: {name} resolved {mode} from the cache")
            pol = ops.execution_policy()
            require(pol["autotune_entries"] == len(rows),
                    f"{label}: policy {pol}")
        finally:
            autotune.CACHE_DIR = saved
            ops.reset_execution_policy()
    return {r["kernel"] + " " + r["sig"]: {"ms": r["ms"],
                                           "oracle_ms": r.get("oracle_ms")}
            for r in rows}


def op_phase(label, name, inputs):
    """The registry op `name` on the inputs a phase captured, as a train
    step runs it: the kernel forward under autograd, then the backward
    through the plain version for random cotangents. For an op with no
    call site in the model (memory_update, as in the JAX package, whose
    kernel benchmark drives the registry op). Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    _, a, kw = inputs[name]
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in a]
    gen = torch.Generator(a[0].device).manual_seed(0)
    ops.reset_launch_counts()
    outs = getattr(ops, name)(*leaves, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [
        torch.randn(o.shape, generator=gen, device=o.device) for o in outs])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_launches(label, counts, (name,))
    require(counts[name] == 1 and all(
        bool(torch.isfinite(x.grad).all()) for x in leaves
        if x.grad is not None), f"{label}: bad launch count or gradient")
    return counts


# ---------------------------------------------------------------------------
# phases zoo-qwen3 / zoo-xlstm / cli-zoo: the model zoo at full width
# ---------------------------------------------------------------------------


def check_routes(label, what, expect, kernels):
    """flash_attn's launches by route (fma: fp32 inputs, wgmma: bf16)."""
    if "flash_attn" not in kernels:
        return
    from repro_torch.kernels import flash_attn as fa
    log(f"[{label}] {what} flash_attn launches by route "
        f"{json.dumps(fa.launches_by_route)}")
    require(fa.launches_by_route == expect, f"{label}: {what} flash_attn "
            f"routes {fa.launches_by_route}, expected {expect}")


def zoo_batch(cfg, model, b, s, gen, dev, targets=False):
    """B x S random tokens (and as many random targets with `targets`)
    and, for the VLM, `num_patches` random patch embeddings (in `model`'s
    dtype: a model casts them to its own) and the M-RoPE positions as
    Qwen2-VL Sec. 3.1 lays them out: the patches on a square grid at t =
    0, then the text from one past the largest patch coordinate, advancing
    in all three; for whisper, random frame embeddings."""
    import torch
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev)}
    if targets:
        batch["targets"] = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                         device=dev)
    if cfg.enc_layers:
        batch["audio_feats"] = torch.randn(
            (b, cfg.enc_frames, cfg.d_model), generator=gen, device=dev,
            dtype=model.cfg.dtype)
    if cfg.num_patches:
        n = cfg.num_patches
        side = int(round(n ** 0.5))
        require(side * side == n, f"{cfg.arch_id}: {n} patches are not a "
                f"square grid")
        i = torch.arange(n, device=dev)
        patch = torch.stack([torch.zeros_like(i), i // side, i % side])
        text = (side + torch.arange(s, device=dev)).expand(3, s)
        pos = torch.cat([patch, text], dim=1).to(torch.int32)
        batch["patch_embeds"] = torch.randn(
            (b, n, cfg.d_model), generator=gen, device=dev,
            dtype=model.cfg.dtype)
        batch["mrope_positions"] = pos.expand(b, 3, n + s).contiguous()
    if model.extra_inputs is not None:
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()
                  if k not in ("tokens", "targets")}
        require(shapes == {k: (tuple(sh), dt) for k, (sh, dt) in
                           model.extra_inputs(b, s).items()},
                f"{cfg.arch_id}: the batch does not match extra_inputs")
    return batch


@contextlib.contextmanager
def _nudge_zoo(eps):
    """Every call of a zoo kernel's plain version adds eps * max(1, |x|) *
    r to each entry x of its outputs, r random signs drawn from a
    generator seeded 0 on entry: a perturbation of the form, and at eps =
    1e-6 about the size, of a kernel's difference from its plain version
    (`TOL`; the edge cases log 1e-7 to 1.5e-5)."""
    import torch
    from repro_torch.kernels import ops
    saved = {n: ops.REGISTRY[n] for n in ZOO_KERNELS}
    gens = {}

    def nudge(x):
        gen = gens.setdefault(x.device, torch.Generator(
            x.device).manual_seed(0))
        r = torch.randint(0, 2, x.shape, generator=gen, device=x.device,
                          dtype=x.dtype) * 2 - 1
        return x + eps * torch.clamp(x.abs(), min=1.0) * r

    def wrap(ref):
        def run(*a, **kw):
            out = ref(*a, **kw)
            return (tuple(nudge(o) for o in out) if isinstance(out, tuple)
                    else nudge(out))
        return run

    for n, spec in saved.items():
        ops.REGISTRY[n] = dataclasses.replace(spec, ref=wrap(spec.ref))
    try:
        yield
    finally:
        ops.REGISTRY.update(saved)


def _zoo_noise_floor(model, params, batch, want):
    """The plain route's own spread: the largest |logits - want| of the
    plain route (`model`) with every zoo kernel's plain output nudged by
    +-1e-6 of its scale (`_nudge_zoo`)."""
    floor = 0.0
    for eps in (1e-6, -1e-6):
        with _nudge_zoo(eps):
            got = model.prefill(params, batch)
        floor = max(floor, float((got - want).abs().max()))
    return floor


def zoo_config(arch, cut=None):
    """The published config of `arch` with the cuts in `cut` (a dtype by
    its torch name)."""
    import torch
    from repro_torch.configs import get_config
    cut = {k: getattr(torch, v) if k.endswith("dtype") else v
           for k, v in (cut or {}).items()}
    return dataclasses.replace(get_config(arch), **cut)


def zoo_inputs(label, dev, seed):
    """The phase's published config (cut by ZOO_CUT), its float32 model,
    weights drawn from `seed` and then the batch (ZOO's B x S tokens, the
    VLM's patches, whisper's frames) from the same generator."""
    import torch
    from repro_torch.archs.api import get_model
    arch, b, s = ZOO[label][:3]
    cfg = zoo_config(arch, ZOO_CUT.get(label))
    model = get_model(dataclasses.replace(cfg, dtype=torch.float32))
    gen = torch.Generator(dev).manual_seed(seed)
    params = model.init(gen, dev)
    return cfg, model, params, zoo_batch(cfg, model, b, s, gen, dev)


class CountWindowed:
    """Counts the flash_attn launches made with a window while entered
    (the launch goes through unchanged)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.saved = ops.REGISTRY["flash_attn"]
        self.n = 0

    def __enter__(self):
        def run(*args, **kw):
            self.n += kw.get("window") is not None
            return self.saved.cuda(*args, **kw)
        self.ops.REGISTRY["flash_attn"] = dataclasses.replace(self.saved,
                                                              cuda=run)
        return self

    def __exit__(self, *exc):
        self.ops.REGISTRY["flash_attn"] = self.saved


class RouteLog:
    """Records each MoE layer's routing while entered: the router
    probabilities' top k + 1 and their ids, and the keep mask of the
    capacity (the calls go through unchanged)."""

    def __init__(self):
        from repro_torch.nn import moe
        self.moe = moe
        self.calls = []

    def __enter__(self):
        route, slots = self.moe._topk_route, self.moe.dispatch_slots
        self.saved = (route, slots)

        def topk_route(logits, k):
            out = route(logits, k)
            top = out[2].topk(k + 1, dim=-1)
            self.calls.append({"k": k, "ids": out[1].clone(),
                               "top": top.values.clone()})
            return out

        def dispatch(topi, n_experts, cap):
            out = slots(topi, n_experts, cap)
            self.calls[-1]["keep"] = out[1].clone()
            return out

        self.moe._topk_route, self.moe.dispatch_slots = topk_route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe._topk_route, self.moe.dispatch_slots = self.saved


def route_flips(label, a, b):
    """Tokens whose top-k set differs between two RouteLogs of the same
    prefill, and assignments whose keep flag differs; logs each layer's
    counts and the flipped tokens' margins (the k-th less the (k+1)-th
    probability of the plain route). Returns the number of flips."""
    import torch
    total = 0
    for i, (x, y) in enumerate(zip(a.calls, b.calls)):
        k = x["k"]
        flip = (torch.sort(x["ids"], -1).values
                != torch.sort(y["ids"], -1).values).any(-1)
        keep = int((x["keep"] != y["keep"]).sum())
        margin = y["top"][:, k - 1] - y["top"][:, k]
        n = int(flip.sum())
        total += n
        log(f"[{label}] MoE layer {i}: {n} of {flip.numel()} tokens' top-{k} "
            f"sets differ between the routes, {keep} keep flags; smallest "
            f"margin {float(margin.min()):.3g}"
            + (f", flipped tokens' margins "
               f"{sorted(margin[flip].tolist())[:8]}" if n else ""))
    return total


def zoo_phase(label, dev, seed, decode_steps=16, profile=0):
    """Prefill at full width: the published config with random weights
    from `seed`, B x S random tokens (and the VLM's patches), through
    `Model.prefill` (the last position's logits, as JAX's prefill spec).
    (1) float32 through the kernel route, counted: each kernel of the
    phase exactly its launches a prefill (ZOO), flash_attn's windowed ones
    too, all on its fp32 route, no other kernel; the logits against the
    plain route (kernels_mode="oracle") within ZOO_TOL. (2) the published
    bfloat16 timed: median of 3 device-synced prefills (after one warm-up
    that captures the kernels' inputs for their rows), tokens/s and peak
    device memory, the same launches a prefill, flash_attn's all on its
    wgmma route. (3) `decode_steps` greedy decode steps from the
    prefill's next token against a cache of S slots: ms a step, and no
    kernel launched. Returns (launch counts of (1), {row key: captured
    inputs}, summary): the row key is the label, and "<label>-local" for
    the first (windowed) flash_attn launch of a phase with windows."""
    import numpy as np
    import torch
    from repro_torch.archs.api import get_model
    from repro_torch.kernels import ops
    from repro_torch.utils.tree import tree_leaves
    arch, b, s, per_prefill, windowed = ZOO[label]
    kernels = tuple(per_prefill)
    cfg, model, params, batch = zoo_inputs(label, dev, seed)
    cfg32 = model.cfg
    n_params = sum(x.numel() for x in tree_leaves(params))
    summary = {"arch": arch, "batch": b, "seq": s,
               "positions": s + cfg.num_patches, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "params": n_params}

    def check_counts(what, counts, reps):
        check_launches(label, counts, kernels)
        require(all(counts[k] == reps * n for k, n in per_prefill.items()),
                f"{label}: {what}: launches {counts}, expected {reps} x "
                f"{per_prefill}")

    with torch.no_grad():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with CountWindowed() as win, RouteLog() as routes:
            got = model.prefill(params, batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts("fp32 prefill", counts, 1)
        require(win.n == windowed, f"{label}: {win.n} windowed flash_attn "
                f"launches, expected {windowed}")
        check_routes(label, "fp32", {"fma": per_prefill.get("flash_attn", 0),
                                     "wgmma": 0}, kernels)
        plain = get_model(dataclasses.replace(cfg32, kernels_mode="oracle"))
        with RouteLog() as plain_routes:
            want = plain.prefill(params, batch)
        flips = route_flips(label, routes, plain_routes)
        del routes, plain_routes
        require(tuple(got.shape) == (b, cfg.vocab)
                and bool(torch.isfinite(got).all()),
                f"{label}: bad prefill logits {tuple(got.shape)}")
        err = float((got - want).abs().max())
        lim = ZOO_TOL * max(1.0, float(want.abs().max()))
        floor = _zoo_noise_floor(plain, params, batch, want)
        log(f"[{label}] fp32 prefill vs plain route: max|diff| {err:.3g} "
            f"(limit {lim:.3g}; the plain route's own spread {floor:.3g}); "
            f"argmax agree {bool((got.argmax(-1) == want.argmax(-1)).all())}")
        if label in ZOO_NOISE_FLOOR or flips:
            lim += floor
        require(err <= lim, f"{label}: prefill logits differ from the plain "
                f"route by {err:.3g} > {lim:.3g}")
        summary.update(fp32_vs_plain=err, fp32_limit=lim,
                       fp32_noise_floor=floor, route_flips=flips)
        del got, want, plain

        bf = get_model(cfg)                     # the published bfloat16
        # each kernel's row takes the prefill's last launch (ssd_chunk's
        # carry-in h0 is then nonzero); with windows, a second row takes
        # the first launch, a windowed layer's
        with Capture(names=kernels) as cap, \
                Capture(names=kernels, latest=False) as first:
            bf.prefill(params, batch)
        inputs = {label: cap.best}
        if windowed:
            inputs[f"{label}-local"] = first.best
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = bf.prefill(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts_bf = ops.launch_counts()
        check_counts("3 bf16 prefills", counts_bf, 3)
        check_routes(label, "bf16 (3 prefills)",
                     {"fma": 0, "wgmma": 3 * per_prefill.get("flash_attn",
                                                              0)}, kernels)
        require(bool(torch.isfinite(last).all()),
                f"{label}: bf16 prefill logits not finite")
        med = float(np.median(secs))
        summary.update(prefill_s=secs, prefill_s_median=med,
                       prefill_tokens_per_s=b * (s + cfg.num_patches) / med,
                       prefill_peak_mem_mb=torch.cuda.max_memory_allocated()
                       / 1e6)

        state = bf.init_decode_state(b, s, dev)
        if bf.encode is not None:           # whisper: the encoder's output
            state["enc_out"] = bf.encode(params, batch["audio_feats"])
        tok = last.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step_ms = []
        for pos in range(decode_steps):
            t0 = time.perf_counter()
            logits, state = bf.decode_step(params, state, tok, pos)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts_dec = ops.launch_counts()
        require(not any(counts_dec.values()),
                f"{label}: decode launched a kernel: {counts_dec}")
        require(tuple(logits.shape) == (b, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"{label}: bad decode logits")
        summary.update(decode_steps=decode_steps, decode_cache=s,
                       decode_ms_first=step_ms[0],
                       decode_ms_median=float(np.median(step_ms[1:])),
                       decode_tokens_per_s=b * 1e3
                       / float(np.median(step_ms[1:])))
        log(f"[{label}] {json.dumps(summary)}")
        if profile:
            DEFERRED_PROFILES.append(functools.partial(
                _profile_prefill, label, dev, seed))
    del params, state
    torch.cuda.empty_cache()
    return counts, inputs, summary


# ---------------------------------------------------------------------------
# zoo training
# ---------------------------------------------------------------------------


def _zoo_grads(model, params, batch):
    """(loss, {leaf path: gradient}) of one loss + backward."""
    from repro_torch.launch import specs
    from repro_torch.utils.tree import tree_leaves
    loss, _, grads = specs.loss_and_grads(model, params, batch)
    return float(loss), dict(zip(_leaf_names(grads), tree_leaves(grads)))


def _grad_limits(want):
    """Each leaf's bare limit: TRAIN_ZOO_TOL["grad"] x max(its largest
    |want|, 1e-3 x the largest |want| of any leaf). Returns {leaf: limit}."""
    top = max(float(w.abs().max()) for w in want.values())
    return {name: TRAIN_ZOO_TOL["grad"] * max(float(w.abs().max()),
                                              1e-3 * top)
            for name, w in want.items()}


def _grad_errors(got, want, spread=None):
    """Each leaf's max |got - want| over its limit: `_grad_limits`'s, plus
    that leaf's entry of `spread` where given. Returns {leaf: ratio}."""
    out = {}
    for name, lim in _grad_limits(want).items():
        lim += (spread or {}).get(name, 0.0)
        out[name] = (float((got[name] - want[name]).abs().max())
                     / max(lim, 1e-30))
    return out


def _train_zoo_inputs(label, dev, seed, dtype):
    """The phase's published config in `dtype`, its model, float32
    weights drawn from `seed` and a B x S batch of tokens and targets."""
    import torch
    from repro_torch.archs.api import get_model
    arch, b, s = TRAIN_ZOO[label][:3]
    cfg = dataclasses.replace(zoo_config(arch), dtype=getattr(torch, dtype))
    model = get_model(cfg)
    gen = torch.Generator(dev).manual_seed(seed)
    params = model.init(gen, dev)
    return cfg, model, params, zoo_batch(cfg, model, b, s, gen, dev,
                                         targets=True)


def train_zoo_phase(label, dev, seed):
    """Zoo training at full width: the published config (remat on), its
    ARCH_OPTIMIZER optimizer at lr 1e-4, random weights and batch from
    `seed`. (1) float32, one loss + gradient from the same parameters and
    batch through the kernels (each kernel exactly its TRAIN_ZOO launches,
    flash_attn's on its fp32 route, no other kernel) and through the plain
    route (kernels_mode="oracle"): the loss and every gradient leaf held
    within TRAIN_ZOO_TOL (in TRAIN_ZOO_NOISE_FLOOR's phases plus the
    plain route's own spread under +-1e-6 nudges of the kernels' plain
    outputs, as `_zoo_noise_floor` adds it to a prefill's). (2) float32,
    TRAIN_ZOO_STEPS free-running steps from the same start on both routes,
    the losses held step by step (with the same spread in the same
    phases). Both under deterministic algorithms. (3)
    the published bfloat16: 1 warm-up and 3 timed steps (median ms,
    tokens/s, peak memory), the same launches a step, flash_attn's on its
    wgmma route. A deferred profile of one step gives the busy share."""
    import numpy as np
    import torch
    from repro_torch.archs.api import get_model
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.utils.tree import tree_leaves, tree_map
    arch, b, s, per_step = TRAIN_ZOO[label]
    kernels = tuple(per_step)
    summary = {"arch": arch, "batch": b, "seq": s,
               "optimizer": specs.ARCH_OPTIMIZER.get(arch, "adamw"),
               "launches_a_step": per_step}

    def check_counts(what, counts, reps, route):
        check_launches(label, counts, kernels)
        require(all(counts[k] == reps * n for k, n in per_step.items()),
                f"{label}: {what}: launches {counts}, expected {reps} x "
                f"{per_step}")
        fa = reps * per_step.get("flash_attn", 0)
        check_routes(label, what, {"fma": fa if route == "fma" else 0,
                                   "wgmma": fa if route == "wgmma" else 0},
                     kernels)

    cfg, model, params, batch = _train_zoo_inputs(label, dev, seed,
                                                  "float32")
    summary["params"] = sum(x.numel() for x in tree_leaves(params))
    plain = get_model(dataclasses.replace(cfg, kernels_mode="oracle"))
    with _deterministic():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        loss, got = _zoo_grads(model, params, batch)
        torch.cuda.synchronize()
        check_counts("fp32 loss + gradient", ops.launch_counts(), 1, "fma")
        ops.reset_launch_counts()
        want_loss, want = _zoo_grads(plain, params, batch)
        require(not any(ops.launch_counts().values()),
                f"{label}: the plain route launched a kernel")
        require(np.isfinite(loss) and all(bool(torch.isfinite(g).all())
                                          for g in got.values()),
                f"{label}: loss or gradients not finite")
        loss_err = abs(loss - want_loss)
        require(loss_err <= TRAIN_ZOO_TOL["loss"] * max(1.0, abs(want_loss)),
                f"{label}: loss {loss} vs the plain route's {want_loss}")
        noise = label in TRAIN_ZOO_NOISE_FLOOR
        bare = _grad_errors(got, want)
        worst = max(bare, key=bare.get)
        log(f"[{label}] fp32 step vs plain route: loss {loss:.6f} vs "
            f"{want_loss:.6f}; worst gradient leaf {worst} at "
            f"{bare[worst]:.3g} of TRAIN_ZOO_TOL's limit")
        ratio, spread = bare, None
        if noise:
            spread = {n: 0.0 for n in want}
            for eps in (1e-6, -1e-6):
                with _nudge_zoo(eps):
                    _, nudged = _zoo_grads(plain, params, batch)
                for n, g in nudged.items():
                    spread[n] = max(spread[n],
                                    float((g - want[n]).abs().max()))
                del nudged
            ratio = _grad_errors(got, want, spread)
            lims = _grad_limits(want)
            rel = {n: spread[n] / max(lims[n], 1e-30) for n in want}
            widest = max(rel, key=rel.get)
            worst = max(ratio, key=ratio.get)
            log(f"[{label}] the plain route's own gradient spread: widest "
                f"{rel[widest]:.3g} x its bare limit ({widest}); worst "
                f"leaf with it {worst} at {ratio[worst]:.3g} of its limit")
        require(ratio[worst] <= 1.0, f"{label}: gradient {worst} differs "
                f"from the plain route's beyond its limit "
                f"({ratio[worst]:.3g} x)")
        summary.update(fp32_loss=loss, fp32_loss_err=loss_err,
                       grad_worst_leaf=worst, grad_worst_ratio=ratio[worst],
                       grad_bare_ratio=max(bare.values()),
                       grad_spread_used=noise)
        del got, want, spread

        # free-running: each route its own copy of the start
        def curve(m, eps=None):
            p = tree_map(lambda t: t.detach().clone(), params)
            opt = specs.make_optimizer(arch, 1e-4)
            step = specs.make_train_step(m, opt)
            st = opt.init(p)
            losses = []
            with (_nudge_zoo(eps) if eps else contextlib.nullcontext()):
                for _ in range(TRAIN_ZOO_STEPS):
                    p, st, lo = step(p, st, batch)
                    losses.append(float(lo))
            return losses

        ops.reset_launch_counts()
        curves = {"kernel": curve(model)}
        check_counts(f"{TRAIN_ZOO_STEPS} fp32 steps", ops.launch_counts(),
                     TRAIN_ZOO_STEPS, "fma")
        curves["plain"] = curve(plain)
        gaps = [abs(a - c) for a, c in zip(curves["kernel"], curves["plain"])]
        lims = [TRAIN_ZOO_TOL["curve"] * max(1.0, abs(c))
                for c in curves["plain"]]
        log(f"[{label}] free-running fp32 losses: kernels {curves['kernel']}"
            f", plain {curves['plain']}")
        require(all(np.isfinite(curves["kernel"])),
                f"{label}: free-running loss not finite")
        log(f"[{label}] free-running: gaps {gaps} against "
            f"TRAIN_ZOO_TOL's limits {lims}")
        spread = None
        if noise:
            spread = [0.0] * TRAIN_ZOO_STEPS
            for eps in (1e-6, -1e-6):
                spread = [max(sp, abs(a - c)) for sp, a, c in
                          zip(spread, curve(plain, eps), curves["plain"])]
            log(f"[{label}] free-running: the plain route's own spread "
                f"{spread}, {[sp / lim for sp, lim in zip(spread, lims)]} "
                f"x the bare limits")
            lims = [lim + sp for lim, sp in zip(lims, spread)]
        require(all(g <= lim for g, lim in zip(gaps, lims)),
                f"{label}: free-running losses apart by {gaps} > {lims}")
        summary.update(curve_kernel=curves["kernel"],
                       curve_plain=curves["plain"], curve_gaps=gaps,
                       curve_limits=lims, curve_spread=spread)
    del model, plain, params, batch
    torch.cuda.empty_cache()

    # the published bfloat16, timed
    cfg, bf, params, batch = _train_zoo_inputs(label, dev, seed, "bfloat16")
    opt = specs.make_optimizer(arch, 1e-4)
    step = specs.make_train_step(bf, opt)
    st = opt.init(params)
    params, st, lo = step(params, st, batch)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    secs, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, lo = step(params, st, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(lo))
    check_counts("3 bf16 steps", ops.launch_counts(), 3, "wgmma")
    require(all(np.isfinite(losses)), f"{label}: bf16 loss not finite")
    med = float(np.median(secs))
    summary.update(bf16_step_s=secs, bf16_step_ms_median=med * 1e3,
                   bf16_tokens_per_s=b * s / med, bf16_losses=losses,
                   bf16_peak_mem_mb=torch.cuda.max_memory_allocated() / 1e6)
    log(f"[{label}] {json.dumps(summary)}")
    del params, st, batch, bf
    torch.cuda.empty_cache()
    DEFERRED_PROFILES.append(functools.partial(_profile_train_zoo, label,
                                               dev, seed))
    return summary


def _profile_train_zoo(label, dev, seed):
    """torch.profiler over one bf16 train step of the phase (after one
    unprofiled step), its weights and batch drawn again from `seed`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import specs
    arch = TRAIN_ZOO[label][0]
    _, bf, params, batch = _train_zoo_inputs(label, dev, seed, "bfloat16")
    opt = specs.make_optimizer(arch, 1e-4)
    step = specs.make_train_step(bf, opt)
    st = opt.init(params)
    params, st, _ = step(params, st, batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, st, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del params, st, batch
    torch.cuda.empty_cache()
    _report_profile(label, prof, wall_us, "one bf16 train step")


def train_zoo_reduced_phase(label, dev, seed):
    """Each of the ten zoo arches reduced (attn_chunk=32, the stacked
    layout, remat on; the VLM's 16 patches on a 4 x 4 grid) at B = 2 and
    64 positions, float32 on the kernel
    route: two train steps with its ARCH_OPTIMIZER optimizer under
    deterministic algorithms, each kernel exactly its TRAIN_ZOO_REDUCED
    launches a step and no other; the losses finite and every parameter
    leaf the loss reaches moved."""
    import torch
    from repro_torch.archs.api import get_model
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.utils.tree import tree_leaves
    require(sorted(TRAIN_ZOO_REDUCED) == sorted(ARCH_IDS),
            f"{label}: TRAIN_ZOO_REDUCED does not cover every arch")
    out = {}
    for arch in ARCH_IDS:
        per_step = TRAIN_ZOO_REDUCED[arch]
        cfg = get_config(arch).reduced(attn_chunk=32, scan_layers=True,
                                       remat=True)
        if cfg.num_patches:
            # zoo_batch lays the patches on a square grid
            cfg = dataclasses.replace(cfg, num_patches=16)
        model = get_model(cfg)
        gen = torch.Generator(dev).manual_seed(seed)
        params = model.init(gen, dev)
        batch = zoo_batch(cfg, model, 2, 64 - cfg.num_patches, gen, dev,
                          targets=True)
        start = [t.detach().clone() for t in tree_leaves(params)]
        opt = specs.make_optimizer(arch, 1e-4)
        step = specs.make_train_step(model, opt)
        st = opt.init(params)
        losses = []
        with _deterministic():
            ops.reset_launch_counts()
            for _ in range(2):
                params, st, lo = step(params, st, batch)
                losses.append(float(lo))
            counts = ops.launch_counts()
        check_launches(f"{label}-{arch}", counts, tuple(per_step))
        require(all(counts[k] == 2 * n for k, n in per_step.items()),
                f"{label}: {arch}: launches {counts}, expected 2 x "
                f"{per_step}")
        moved = [bool((a != b).any())
                 for a, b in zip(start, tree_leaves(params))]
        require(all(torch.isfinite(torch.tensor(losses))),
                f"{label}: {arch}: losses {losses}")
        # a leaf the loss does not reach (the padded vocab rows are inside
        # the embedding leaf, so every leaf is reached) keeps its values
        require(all(moved), f"{label}: {arch}: {moved.count(False)} "
                f"parameter leaves did not move")
        out[arch] = {"losses": losses, "launches": per_step,
                     "optimizer": specs.ARCH_OPTIMIZER.get(arch, "adamw")}
        log(f"[{label}] {arch}: {json.dumps(out[arch])}")
    return out


def cli_zoo_phase(label, arch, steps):
    """`python -m repro_torch.launch.serve --zoo <arch>` on the card (its
    default device): greedy decode of the reduced config, which launches
    no kernel (the zoo's kernels run in the prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    ops.reset_launch_counts()
    toks = serve_cli.main(["--zoo", arch, "--steps", str(steps)])
    counts = ops.launch_counts()
    require(not any(counts.values()),
            f"{label}: the zoo decode CLI launched a kernel: {counts}")
    require(tuple(toks.shape) == (2, steps), f"{label}: bad tokens")
    return {"tokens": toks[0].tolist()}


# ---------------------------------------------------------------------------
# phases spec-zoo-*, dryrun: the zoo's sharded specs on a 1x1 DeviceMesh
# and the dry run
# ---------------------------------------------------------------------------


def _spec_mesh():
    """The 1x1 ("data", "model") DeviceMesh of the spec phases (inside
    `_nccl_group`), DTensor's per-step advice silenced."""
    from repro_torch.launch import mesh as mesh_lib
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    warnings.filterwarnings("ignore", message=".*local_tensor.detach")
    warnings.filterwarnings("ignore", message=".*tensor.detach\\(\\) first")
    return mesh_lib.make_debug_mesh(1, 1, device_type="cuda")


def _synced(fn, *a, **kw):
    """(fn's result, its device-synced ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _spec_launches(label, what, fn, expect, route):
    """fn() with the launch counters zeroed just before it and read just
    after: each kernel of `expect` exactly its count, flash_attn's all on
    `route`, no other kernel. Returns (fn's result, its ms)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out, ms = _synced(fn)
    counts = ops.launch_counts()
    check_launches(f"{label} {what}", counts, tuple(expect))
    require(all(counts[k] == n for k, n in expect.items()),
            f"{label}: {what}: launches {counts}, expected {expect}")
    fa = expect.get("flash_attn", 0)
    check_routes(label, what, {"fma": fa if route == "fma" else 0,
                               "wgmma": fa if route == "wgmma" else 0},
                 tuple(expect))
    return out, ms


def _max_diff(a, b):
    """max |a - b| over the tensors of two trees of one layout."""
    la, lb = _flat(a), _flat(b)
    require(len(la) == len(lb), "trees of different layouts")
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(la, lb))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def spec_prefill(label, cfg, model, params, batch, mesh, expect):
    """`make_prefill_spec` through `apply_spec` against `Model.prefill` on
    the same weights and tokens, both under deterministic algorithms,
    each counted at `expect` (flash_attn on the bf16 route): the logits'
    largest difference within ZOO_TOL of their scale, both ms (each
    after one warm-up call)."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.launch import specs
    from repro_torch.train import distributed as tdist
    b, s = batch["tokens"].shape
    spec = specs.make_prefill_spec(cfg, InputShape("p", s, b, "prefill"),
                                   mesh)
    with torch.no_grad(), _deterministic():
        model.prefill(params, batch)
        tdist.apply_spec(spec, mesh, params, batch)
        want, single_ms = _spec_launches(
            label, "single-device prefill",
            lambda: model.prefill(params, batch), expect, "wgmma")
        got, spec_ms = _spec_launches(
            label, "prefill spec",
            lambda: tdist.full_tree(tdist.apply_spec(spec, mesh, params,
                                                     batch)),
            expect, "wgmma")
    require(tuple(got.shape) == (b, cfg.vocab)
            and bool(torch.isfinite(got).all()),
            f"{label}: bad prefill spec logits {tuple(got.shape)}")
    err = _max_diff(got, want)
    lim = ZOO_TOL * max(1.0, float(want.float().abs().max()))
    require(err <= lim, f"{label}: the prefill spec's logits differ from "
            f"Model.prefill's by {err:.3g} > {lim:.3g}")
    return {"batch": b, "seq": s, "launches": expect, "max_abs_diff": err,
            "limit": lim, "single_ms": single_ms, "spec_ms": spec_ms}, want


def spec_decode(label, cfg, model, params, first, mesh, steps, cache):
    """`steps` steps of `make_decode_spec` through `apply_spec` against
    `decode_step`, each from its own zero state of `cache` slots, fed the
    same tokens (the single-device step's greedy choice, from `first`):
    the logits' and the final caches' largest differences within ZOO_TOL
    of their scale, no kernel launched, median ms a step."""
    import numpy as np
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.train import distributed as tdist
    b = first.shape[0]
    dev = first.device
    spec = specs.make_decode_spec(cfg, InputShape("d", cache, b, "decode"),
                                  mesh)
    mine = model.init_decode_state(b, cache, dev)
    theirs = model.init_decode_state(b, cache, dev)
    tok, err, scale, single, dist_ms = first, 0.0, 1.0, [], []
    with torch.no_grad(), _deterministic():
        ops.reset_launch_counts()
        for pos in range(steps):
            (want, mine), ms = _synced(model.decode_step, params, mine, tok,
                                       pos)
            single.append(ms)
            out, ms = _synced(tdist.apply_spec, spec, mesh, params, theirs,
                              tok, torch.tensor(pos, dtype=torch.int32,
                                                device=dev))
            dist_ms.append(ms)
            theirs = out[1]
            got = tdist.full_tree(out[0])
            err = max(err, _max_diff(got, want))
            scale = max(scale, float(want.abs().max()))
            tok = want[:, -1].argmax(-1, keepdim=True)
        counts = ops.launch_counts()
    require(not any(counts.values()),
            f"{label}: decode launched a kernel: {counts}")
    cache_err = _max_diff(tdist.full_tree(theirs), mine)
    lim = ZOO_TOL * scale
    require(err <= lim and cache_err <= ZOO_TOL * max(
        1.0, max(float(t.float().abs().max()) for t in _flat(mine))),
        f"{label}: the decode spec differs from decode_step: logits "
        f"{err:.3g}, caches {cache_err:.3g} (limit {lim:.3g})")
    return {"steps": steps, "cache": cache, "max_abs_diff": err,
            "cache_max_abs_diff": cache_err, "limit": lim,
            "single_ms_median": float(np.median(single[1:])),
            "spec_ms_median": float(np.median(dist_ms[1:]))}


def spec_train(label, cfg, model, params_fn, batch, mesh, expect):
    """One step of `make_train_spec` through `apply_spec` against
    `make_train_step` (the arch's optimizer at lr 1e-4, as the spec's),
    each from its own copy of the seeded weights (`params_fn()`), both
    under deterministic algorithms and counted at `expect`: the loss
    within TRAIN_ZOO_TOL["loss"], each first-moment leaf (0.1 x the
    gradient) within TRAIN_ZOO_TOL["grad"] of its scale (`_grad_limits`),
    and each parameter leaf after the step within 1e-3 x lr where its
    gradient is at least 1e-3 of the leaf's largest (AdamW's first step
    moves an entry whose gradient is near its eps by rounding of order
    lr) and within 2 x lr everywhere; both ms (each after one warm-up
    step on another copy)."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.launch import specs
    from repro_torch.train import distributed as tdist
    from repro_torch.utils.tree import tree_leaves
    b, s = batch["tokens"].shape
    spec = specs.make_train_spec(cfg, InputShape("t", s, b, "train"), mesh)
    opt = specs.make_optimizer(cfg.arch_id, 1e-4)
    step = specs.make_train_step(model, opt)
    with _deterministic():
        w = params_fn()
        step(w, opt.init(w), batch)
        w = params_fn()
        tdist.apply_spec(spec, mesh, w, opt.init(w), batch)
        del w
        p = params_fn()
        p_st = opt.init(p)
        (p1, st1, loss1), single_ms = _spec_launches(
            label, "single-device train step",
            lambda: step(p, p_st, batch), expect, "wgmma")
        q = params_fn()
        q_st = opt.init(q)
        (p2, st2, loss2), spec_ms = _spec_launches(
            label, "train spec step",
            lambda: tdist.full_tree(tdist.apply_spec(spec, mesh, q, q_st,
                                                     batch)),
            expect, "wgmma")
    loss_err = abs(float(loss2) - float(loss1))
    require(loss_err <= TRAIN_ZOO_TOL["loss"] * max(1.0, abs(float(loss1))),
            f"{label}: train spec loss {float(loss2)} against "
            f"{float(loss1)}")
    mu1 = dict(zip(_leaf_names(st1["mu"]), tree_leaves(st1["mu"])))
    mu2 = dict(zip(_leaf_names(st2["mu"]), tree_leaves(st2["mu"])))
    mu_err = max(_grad_errors(mu2, mu1).values())
    require(mu_err <= 1.0, f"{label}: the train spec's first moments "
            f"differ by {mu_err:.3g} x TRAIN_ZOO_TOL's limits")
    worst_big, worst = 0.0, 0.0
    for name, a, b_ in zip(_leaf_names(p1), tree_leaves(p1),
                           tree_leaves(p2)):
        d = (a - b_).detach().abs()
        g = mu1[name].abs()
        big = g >= 1e-3 * g.max()
        worst = max(worst, float(d.max()))
        if bool(big.any()):
            worst_big = max(worst_big, float(d[big].max()))
    require(worst_big <= 1e-3 * 1e-4 and worst <= 2e-4,
            f"{label}: parameters after the spec's step differ by "
            f"{worst_big:.3g} (large gradients) / {worst:.3g} (all)")
    return {"batch": b, "seq": s, "launches": expect,
            "optimizer": specs.ARCH_OPTIMIZER.get(cfg.arch_id, "adamw"),
            "loss": float(loss1), "loss_diff": loss_err,
            "moments_vs_limit": mu_err, "params_max_abs_diff": worst,
            "params_max_abs_diff_large_grad": worst_big,
            "single_ms": single_ms, "spec_ms": spec_ms}


def spec_zoo_phase(label, dev, seed):
    """A zoo arch's sharded specs (launch/specs.py) at full width on a 1x1
    DeviceMesh over an NCCL group of world 1, from the seeded weights and
    tokens of the single-device calls they are held against (SPEC_ZOO):
    the prefill spec (the published bfloat16, flash_attn on its wgmma
    route through annotate.local); for qwen3 also 16 decode-spec steps
    and one train-spec step (B 1, S 4,096)."""
    import torch
    from repro_torch.archs.api import get_model
    arch, b, s, expect, parts = SPEC_ZOO[label]
    cfg = zoo_config(arch)
    model = get_model(cfg)
    gen = torch.Generator(dev).manual_seed(seed)
    params = model.init(gen, dev)
    batch = zoo_batch(cfg, model, b, s, gen, dev)
    summary = {"arch": arch}
    with _nccl_group(dev):
        mesh = _spec_mesh()
        summary["prefill"], logits = spec_prefill(label, cfg, model, params,
                                                  batch, mesh, expect)
        if "decode" in parts:
            summary["decode"] = spec_decode(
                label, cfg, model, params,
                logits.argmax(-1, keepdim=True), mesh, 16, s)
        del params, logits
        torch.cuda.empty_cache()
        if "train" in parts:
            tb, ts, texpect = parts["train"]

            def fresh():
                return model.init(torch.Generator(dev).manual_seed(seed),
                                  dev)

            tbatch = zoo_batch(cfg, model, tb, ts,
                               torch.Generator(dev).manual_seed(seed + 1),
                               dev, targets=True)
            summary["train"] = spec_train(label, cfg, model, fresh, tbatch,
                                          mesh, texpect)
    torch.cuda.empty_cache()
    log(f"[{label}] {json.dumps(summary)}")
    return summary


def spec_zoo_fsdp_phase(label, dev, seed):
    """The reduced gemma3 (bfloat16, the stacked layout, attn_chunk=32:
    its 2 layers take the blockwise branch) train spec under the "fsdp"
    rules on a 1x1 DeviceMesh over an NCCL group of world 1, with the
    weight-gather hook installed (gemma3 is in WEIGHT_GATHER_ARCHS) and
    without it, from the same seeded weights and batch: the losses equal
    within TRAIN_ZOO_TOL["loss"], each step 2 flash_attn launches (the
    forward; the backward runs the plain version), DTensor's collectives
    logged."""
    import torch
    from repro_torch.archs.api import get_model
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import specs
    from repro_torch.train import distributed as tdist
    cfg = get_config("gemma3-12b").reduced(attn_chunk=32, scan_layers=True,
                                           dtype=torch.bfloat16)
    model = get_model(cfg)
    shape = InputShape("t", 64, 2, "train")
    require(specs.rules_for(cfg.arch_id, shape)["embed"] == "data"
            and cfg.arch_id in specs.WEIGHT_GATHER_ARCHS,
            f"{label}: gemma3 is not an FSDP weight-gather arch")
    batch = zoo_batch(cfg, model, 2, 64, torch.Generator(dev).manual_seed(
        seed + 1), dev, targets=True)
    out = {}
    saved = specs.WEIGHT_GATHER_ARCHS
    with _nccl_group(dev), _deterministic():
        mesh = _spec_mesh()
        for hook in (True, False):
            specs.WEIGHT_GATHER_ARCHS = saved if hook else set()
            try:
                spec = specs.make_train_spec(cfg, shape, mesh)
            finally:
                specs.WEIGHT_GATHER_ARCHS = saved
            p = model.init(torch.Generator(dev).manual_seed(seed), dev)
            opt = specs.make_optimizer(cfg.arch_id, 1e-4)
            st = opt.init(p)

            def run():
                with tdist.collective_log() as comm:
                    res = tdist.full_tree(tdist.apply_spec(spec, mesh, p, st,
                                                           batch))
                return res, comm

            (res, comm), ms = _spec_launches(
                label, f"train spec {'with' if hook else 'without'} hook",
                run, {"flash_attn": 2}, "wgmma")
            out["hook" if hook else "no_hook"] = {
                "loss": float(res[2]), "ms": ms,
                "collectives": {str(k): v for k, v in
                                comm.get_comm_counts().items()}}
    a, b_ = out["hook"]["loss"], out["no_hook"]["loss"]
    require(abs(a - b_) <= TRAIN_ZOO_TOL["loss"] * max(1.0, abs(b_)),
            f"{label}: the hooked spec's loss {a} against {b_}")
    out["loss_diff"] = abs(a - b_)
    log(f"[{label}] {json.dumps(out)}")
    return out


def dryrun_phase(label):
    """The dry-run CLI (`repro_torch.launch.dryrun.main`, in this process:
    the spec phases before it have torn their process group down) on
    this host for DRYRUN's pairs on the 16x16 mesh (meta tensors over a
    FakeStore group of 256 ranks; no kernel, no device): each pair's JSON
    has status "ok", nonzero collective bytes and a finite bottleneck
    term."""
    import math
    import tempfile
    from repro_torch.launch import dryrun
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, extra in DRYRUN:
            dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                         "single", "--out", tmp] + extra)
            path = pathlib.Path(tmp) / f"{arch}__{shape}__single.json"
            res = json.loads(path.read_text())
            require(res["status"] == "ok",
                    f"{label}: {arch} x {shape}: {res.get('error')!r}\n"
                    f"{res.get('traceback', '')[-3000:]}")
            require(res["collective_bytes_per_device"] > 0
                    and math.isfinite(res[f"{res['bottleneck']}_s"]),
                    f"{label}: {arch} x {shape}: {res}")
            key = f"{arch}__{shape}"
            out[key] = {k: v for k, v in res.items()
                        if k != "memory_analysis"}
            log(f"[{label}] {arch} x {shape}: {json.dumps(out[key])}")
    return out


def library_gru_cell(args):
    """torch.gru_cell computing the port's cell on the same inputs, as the
    kernel's yardstick (never on the path). PyTorch's z weights h, the
    port's weights n: with the z blocks of W, U and b negated,
    sigmoid(-a) = 1 - sigmoid(a) turns one into the other. The hidden bias
    is zero (the port has none)."""
    import torch
    x, h, w, u, b = args
    d = h.shape[1]
    flip = torch.ones(3 * d, device=x.device)
    flip[d:2 * d] = -1.0
    w_ih = (w * flip).t().contiguous()
    w_hh = (u * flip).t().contiguous()
    b_ih = (b * flip).contiguous()
    b_hh = torch.zeros_like(b_ih)
    return lambda: torch.gru_cell(x, h, w_ih, w_hh, b_ih, b_hh), args


def library_neighbor_attn(args):
    """scaled_dot_product_attention with a boolean mask computing the
    kernel's function, as its yardstick (never on the path): one query a
    row, batch M, one head. SDPA gives NaN for a row with no valid slot,
    so rows with none get slot 0 valid; the yardstick and the plain
    version it is checked against both take those inputs."""
    import torch
    import torch.nn.functional as F
    q, k, v, valid = args
    valid = valid.clone()
    valid[~valid.any(1), 0] = True
    q4, k4, v4 = q[:, None, None], k[:, None], v[:, None]
    mask = valid[:, None, None]
    return (lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask)[:, 0, 0],
            [q, k, v, valid])


def library_flash_attn(args, window=None):
    """scaled_dot_product_attention (causal, GQA) on the same tensors laid
    out as (1, heads, S, D), as the kernel's yardstick (never on the
    path); a window (gemma3's local layers) as a boolean mask. Only the
    path's inputs reach it: causal, S = T."""
    import torch
    import torch.nn.functional as F
    q, k, v = args
    q4, k4, v4 = q[None], k[None], v[None]
    if window is None:
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)[0], [q, k, v])
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    return (lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True)[0], [q, k, v])


LIBRARY = {"gru_cell": library_gru_cell,
           "neighbor_attn": library_neighbor_attn,
           "flash_attn": library_flash_attn}

# phase groups, in the order they run; `--only` picks some
PHASES = ("edge", "serve-config", "serve-production", "serve-config-apan",
          "serve-production-apan", "serve-config-rnn", "serve-production-rnn",
          "serve-config-jodie", "serve-production-jodie", "serve-config-std",
          "serve-config-plain", "serve-parity",
          "train-config", "cli", "train-production", "train-config-pipe",
          "train-config-dense", "train-config-apan", "train-config-rnn",
          "train-config-rnn-std", "train-config-time", "train-config-jodie",
          "train-config-buckets", "train-config-pipe-buckets",
          "train-config-plain", "cli-new", "cli-time", "cli-jodie",
          "cli-plain", "cli-ckpt", "cli-csv", "train-production-pipe", "train-production-dense",
          "train-production-apan", "train-production-rnn",
          "train-production-jodie", "train-config-scan",
          "train-production-scan", "train-production-store", "cli-store",
          "cli-obs", "train-config-shards", "train-production-shard4",
          "train-config-bf16", "train-production-bf16", "cli-shards",
          "spec-mdgnn", "spec-mdgnn-compact", "spec-mdgnn-optimized",
          "spec-mdgnn-pipe", "spec-mdgnn-scan") + tuple(ZOO) + tuple(TRAIN_ZOO) + (
              "train-zoo-reduced",) + tuple(SPEC_ZOO) + (
              "spec-zoo-fsdp", "dryrun", "cli-zoo", "autotune")


def kernel_row(name, spec, phase, inputs, counts, row_name=None):
    """Check the kernel on the inputs its phase captured, time it, its
    plain version and (where one exists) the library yardstick, and set
    the bound beside them. `row_name` names a row of another
    instantiation (the table kernel on a bf16 table)."""
    import torch
    from repro_torch.kernels import ops
    _, a, kw = inputs[name]
    err = check_kernel(name, a, kw, f"{phase} inputs")
    copies = [x.clone() for x in a]
    run = lambda: ops.dispatch(name, *copies, mode="compiled", **kw)
    ms = time_ms(run)
    parts = {}
    dev_ms = device_ms(run, by_kernel=parts)
    plain_ms = time_ms(lambda: ops.dispatch(name, *copies, mode="oracle",
                                            **kw))
    library_ms = lib_dev_ms = None
    if name in LIBRARY:
        lib, lib_args = (LIBRARY[name](copies, kw.get("window"))
                         if name == "flash_attn" else LIBRARY[name](copies))
        out = lib()
        if out.dtype == torch.bfloat16:
            # SDPA rounds its probabilities to bf16 before the product
            # with v: held to 2^-6 of the output's scale (a few bf16 ulps;
            # the kernel, which splits them into two bf16 parts, to one
            # ulp)
            want32 = ops.dispatch(name, *[x.float() for x in lib_args],
                                  mode="oracle", **kw)
            lib_err = float((out.float() - want32).abs().max())
            ok = lib_err <= 2 ** -6 * max(1.0, float(want32.abs().max()))
        else:
            want = ops.dispatch(name, *lib_args, mode="oracle", **kw)
            lib_err = float((out - want).abs().max())
            ok = lib_err <= TOL[name] * max(1.0, float(want.abs().max()))
        require(ok, f"{name}: the library yardstick differs by {lib_err}")
        library_ms = time_ms(lib)
        lib_dev_ms = device_ms(lib)
    b_ms, b_by = bound(name, a, kw)
    row = {"name": row_name or name, "phase": phase, "route": "cuda",
           "source": SOURCES[name],
           "replaces": spec.replaces, "launches": counts[name],
           "max_abs_err": err, "tol": TOL[name], "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "library_device_ms": lib_dev_ms, "shape": shape_of(name, a)}
    if len(parts) > 1:
        # a call of several kernels (the table kernel's two phases): each
        row["device_ms_by_kernel"] = parts
    if name in ("memory_update_table", "memory_update", "ssd_chunk",
                "link_score"):
        # the bound with every operation on the fp32 units (fp32_flops)
        nbytes = work(name, a, kw)[0]
        row["fp32_bound_ms"] = max(nbytes / PEAK_BYTES,
                                   fp32_flops(name, a) / PEAK_FP32) * 1e3
    if name == "embed_attn":
        # the fold runs at every shape; the bound of the form before it
        nbytes, flops = direct_work(a)
        row.update(kernel_route="fold", U=a[1].shape[0],
                   direct_bound_ms=max(nbytes / PEAK_BYTES,
                                       flops / PEAK_FP32) * 1e3)
    if name == "flash_attn":
        # which of its two kernels ran, the products' rate and the share of
        # the bound (at the bf16 tensor-core peak for bf16 inputs)
        from repro_torch.kernels import flash_attn as fa
        route = fa.ROUTES[a[0].dtype]
        g, s_, d = a[0].shape
        prod = 4 * d * g * attn_pairs(s_, a[1].shape[1],
                                      kw.get("causal", True), kw.get("window"))
        row.update(source=FLASH_SOURCES[route], kernel_route=route,
                   tflops=prod / (ms * 1e-3) / 1e12, bound_share=b_ms / ms)
    if name == "memory_update" and copies[1].dtype == torch.float32:
        # the fusion's yardstick: the gru_cell and pres_filter kernels in
        # turn on the same inputs (fp32 rows h only)
        x, h, w, u, b, dm, scale, gamma = copies
        row["composed_ms"] = time_ms(lambda: ops.pres_filter(
            h, ops.gru_cell(x, h, w, u, b, mode="compiled"), dm, scale,
            gamma, mode="compiled", **kw))
    log(f"[kernel:{phase}] {json.dumps(row)}")
    return row


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the result lines as JSON to this file")
    ap.add_argument("--profile", type=int, default=0, metavar="TICKS",
                    help="also profile TICKS query+fold rounds of each "
                         "serve phase's engine, TICKS train steps of each "
                         "train phase and one prefill of each zoo phase, "
                         "after the kernel rows")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the zoo phases' weights and tokens")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (default: all): "
                         + ", ".join(PHASES) + "; the kernel rows then "
                         "cover the kernels those phases captured")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(PHASES)
    unknown = only - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    # every phase holds the kernels against their plain versions by mode;
    # a pinned mode for the whole process would void that
    require(not os.environ.get("REPRO_KERNELS_MODE"),
            "REPRO_KERNELS_MODE is set; chip_smoke.py runs with it unset")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no output"
    log(card)
    dev = torch.device("cuda", 0)
    log(f"[device] {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {len(_build.sources())} sources for sm_90a in "
        f"{time.perf_counter() - t0:.1f}s")
    check_tensor_core_build(_build.build().parent)

    seconds = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = round(time.perf_counter() - t, 1)
        log(f"[{name}] phase took {seconds[name]}s")
        return out

    # 3. edge shapes
    # the dense memory_update on a bf16 table's rows h: the edge cases,
    # timed with the kernel rows at CONFIG and PRODUCTION widths
    bf16h = []
    if "edge" in only:
        for name, a, kw, label in edge_cases(dev):
            err = check_kernel(name, a, kw, label)
            log(f"[edge] {name} {label}: max_abs_err={err:.3g}")
            if name == "memory_update" and label.startswith("bf16 h"):
                bf16h.append((label, a, kw))
        softcap_check(dev)

    from repro_torch.configs import tgn_pres
    from repro_torch.graph import datasets
    spec = datasets.SPECS["wiki-small"]
    wiki = datasets.get_dataset("wiki-small", 0)
    _, wiki_serve = wiki.train_serve_split(0.3)
    wiki_dst = (spec.n_users, spec.n_users + spec.n_items)
    rp = lambda c, **kw: dataclasses.replace(c, **kw)
    # the paper model's configs, cut in scale only: n_nodes from the graph
    # that runs them (wiki-small's 1,000; stream-small's 120,000 where
    # PRODUCTION names 1,048,576), d_edge from the dataset (16 in both;
    # PRODUCTION names 172), in RAM (event_store=None; train-production-
    # store runs PRODUCTION over its own store's node space), and the
    # kernels on (use_kernels=True); every width is the published one
    cfg = rp(tgn_pres.CONFIG, n_nodes=wiki.num_nodes, d_edge=wiki.feat_dim,
             use_kernels=True)
    sspec = datasets.STREAM_SPECS["stream-small"]
    n_events = 307_200
    stream = None
    if any(p.endswith("production") or "production-" in p
           or p == "spec-mdgnn" for p in only):
        stream = datasets.stream_events(sspec, 0, n_events + 11_000)
    s_dst = (sspec.n_users, sspec.num_nodes)
    pcfg = rp(tgn_pres.PRODUCTION, n_nodes=sspec.num_nodes,
              d_edge=sspec.feat_dim, event_store=None, use_kernels=True)
    apan = dict(variant="apan")
    dense = dict(dedup_embed=False)
    pipe = dict(pipeline_depth=2)
    jodie = dict(variant="jodie")
    # kernel name -> {"config" / "production": (captured inputs, counts)}
    captured = {}

    def keep(names, phase, inputs, counts):
        for n in names:
            if n in inputs:
                captured.setdefault(n, {})[phase] = (inputs, counts)

    # 4-5. serve at CONFIG widths on wiki-small (then the same replay
    # through the plain versions), PRODUCTION on stream-small
    serve_sum = {}
    rnn = dict(memory_cell="rnn")

    def serve(label, c, phase, expect, capture=(), key=None, exact=False):
        if label not in only:
            return
        prod = phase == "production"
        run = (dict(stream=stream, dst_range=s_dst, rate=100_000.0,
                    tick=1000 / 100_000.0, max_events=n_events,
                    topk_src=stream.src[:16], oracle_replay=False,
                    probe=1000) if prod else
               dict(stream=wiki_serve, dst_range=wiki_dst, rate=5000.0,
                    tick=200 / 5000.0, max_events=5000,
                    topk_src=wiki_serve.src[:8], oracle_replay=True,
                    probe=200))
        counts, inputs, serve_sum[label] = timed(
            label, serve_phase, label, c, dev=dev, query_batch=32, k=10,
            big_query=1024, expect=expect, profile=args.profile,
            exact=exact, **run)
        keep(capture, key or phase, inputs, counts)

    serve("serve-config", cfg, "config", SERVE_KERNELS, SERVE_KERNELS)
    serve("serve-production", pcfg, "production", SERVE_KERNELS,
          SERVE_KERNELS)
    serve("serve-config-apan", rp(cfg, **apan), "config", APAN_SERVE_KERNELS)
    serve("serve-production-apan", rp(pcfg, **apan), "production",
          APAN_SERVE_KERNELS)
    serve("serve-config-rnn", rp(cfg, **rnn), "config", RNN_SERVE_KERNELS)
    serve("serve-production-rnn", rp(pcfg, **rnn), "production",
          RNN_SERVE_KERNELS, ("pres_filter",), key="serve-production")
    serve("serve-config-jodie", rp(cfg, **jodie), "config",
          JODIE_SERVE_KERNELS)
    serve("serve-production-jodie", rp(pcfg, **jodie), "production",
          JODIE_SERVE_KERNELS)
    # the cell routes at CONFIG widths, held bit for bit against the eager
    # engine: Alg. 1 (the gru_cell kernel) and the plain route (no launch)
    serve("serve-config-std", rp(cfg, use_pres=False), "config",
          STD_SERVE_KERNELS, exact=True)
    serve("serve-config-plain", rp(cfg, use_kernels=False), "config", (),
          exact=True)
    if "serve-parity" in only:
        # the offline-parity gate at CONFIG widths on wiki-small's first
        # 6,400 events (100 batches of 64)
        serve_sum["serve-parity"] = timed(
            "serve-parity", parity_phase, "serve-parity", cfg,
            wiki.slice(0, 6400), wiki_dst, dev)

    # 6-8. training: one epoch + evaluate at CONFIG widths on wiki-small
    # (compared with the plain route), 40 steps at PRODUCTION widths on the
    # first 41,000 stream-small events
    train_s, val_s, _ = wiki.chronological_split()
    head = stream.slice(0, 41_000) if stream is not None else None
    train_sum = {}

    def train(label, c, phase, expect, capture=(), against=None,
              noise_floor=False):
        prod = phase == "production"
        counts, inputs, train_sum[label] = timed(
            label, train_phase, label, c, head if prod else train_s,
            None if prod else val_s, s_dst if prod else wiki_dst, dev,
            batch_size=1000 if prod else 500, n_batches=41 if prod else None,
            expect=expect, oracle_steps=3 if prod else None, capture=capture,
            profile=args.profile, against=against, noise_floor=noise_floor)
        keep(capture, phase, inputs, counts)
        if "memory_update" in capture:
            # the dense op on this phase's occurrences, counted on its own
            label = f"op-memory-update-{phase}"
            counts = timed(label, op_phase, label, "memory_update", inputs)
            keep(("memory_update",), phase, inputs, counts)

    pres_path = ("memory_update_table", "embed_attn")
    std_path = ("gru_cell", "embed_attn")
    na_path = ("memory_update_table", "neighbor_attn")
    pipe_path = pres_path + ("pres_predict",)
    rnn_path = ("pres_filter", "embed_attn")
    if "train-config" in only:
        train("train-config-pres", cfg, "config", pres_path,
              capture=("memory_update",))
        train("train-config-std", rp(cfg, use_pres=False), "config",
              std_path, capture=("gru_cell",))
    cli = ["--dataset", "wiki-small", "--model", "tgn", "--use-kernels",
           "--epochs", "1"]

    def cli_run(label, argv, expect):
        train_sum[label] = timed(f"train-{label}", cli_phase,
                                 f"train-{label}", cli + argv, expect)

    if "cli" in only:
        cli_run("cli-pres", ["--pres"], pres_path)
        cli_run("cli-std", [], std_path)
    if "train-production" in only:
        train("train-production-pres", pcfg, "production", pres_path,
              capture=("memory_update",))
        train("train-production-std", rp(pcfg, use_pres=False),
              "production", std_path, capture=("gru_cell",))
    if "train-config-pipe" in only:
        train("train-config-pipe-d1", rp(cfg, pipeline_depth=1), "config",
              pipe_path)
        train("train-config-pipe", rp(cfg, **pipe), "config", pipe_path,
              capture=("pres_predict",))
    if "train-config-dense" in only:
        train("train-config-dense", rp(cfg, **dense), "config", na_path,
              capture=("neighbor_attn",))
    if "train-config-apan" in only:
        train("train-config-apan", rp(cfg, **apan), "config", na_path)
    if "train-config-rnn" in only:
        train("train-config-rnn", rp(cfg, **rnn), "config", rnn_path,
              capture=("pres_filter",))
    if "train-config-rnn-std" in only:
        train("train-config-rnn-std", rp(cfg, use_pres=False, **rnn),
              "config", ("embed_attn",))
    if "train-config-time" in only:
        train("train-config-time", rp(cfg, pres_scale="time",
                                      aggregator="mean", **pipe),
              "config", pipe_path)
    if "train-config-jodie" in only:
        # JODIE's free-running run moves by more than the limits when the
        # plain route's table is perturbed at the size of a kernel's
        # rounding: its free-running gaps are held to the limits beyond
        # that spread (the per-step check, every step from the same state,
        # is unchanged)
        train("train-config-jodie", rp(cfg, **jodie), "config",
              ("memory_update_table",), noise_floor=True)
        train("train-config-jodie-std", rp(cfg, use_pres=False, **jodie),
              "config", ("gru_cell",), noise_floor=True)
    # Sec. 5.3's hashed trackers at |V| / 16 (buckets_ablation.py's point)
    buckets = dict(pres_buckets=cfg.n_nodes // 16)
    if "train-config-buckets" in only:
        train("train-config-buckets", rp(cfg, **buckets), "config",
              pres_path)
    if "train-config-pipe-buckets" in only:
        train("train-config-pipe-buckets", rp(cfg, **buckets, **pipe),
              "config", pipe_path)
    if "train-config-plain" in only:
        # the reference's plain route: no kernel, held against the kernel
        # route of train-config-pres on the same batches and negatives
        train("train-config-plain", rp(cfg, use_kernels=False), "config",
              (), against=cfg)
    if "cli-new" in only:
        cli_run("cli-pipe", ["--pres", "--pipeline-depth", "2"], pipe_path)
        cli_run("cli-dense", ["--pres", "--no-dedup-embed"], na_path)
        train_sum["cli-apan"] = timed(
            "train-cli-apan", cli_phase, "train-cli-apan",
            ["--dataset", "wiki-small", "--model", "apan", "--use-kernels",
             "--epochs", "1", "--pres"], na_path)
    if "cli-time" in only:
        cli_run("cli-time", ["--pres", "--pres-scale", "time"], pres_path)
    if "cli-jodie" in only:
        cli_run("cli-jodie", ["--pres", "--model", "jodie"],
                ("memory_update_table",))
    if "cli-plain" in only:
        # no --use-kernels: the plain route, no launch
        train_sum["cli-plain"] = timed(
            "train-cli-plain", cli_phase, "train-cli-plain",
            ["--dataset", "wiki-small", "--model", "tgn", "--epochs", "1",
             "--pres"], ())
    if "cli-ckpt" in only:
        train_sum["cli-ckpt"] = timed(
            "cli-ckpt", cli_ckpt_phase, "cli-ckpt", cfg, wiki_serve,
            wiki_dst, dev, pres_path)
    if "cli-csv" in only:
        train_sum["cli-csv"] = timed("cli-csv", cli_csv_phase, "cli-csv",
                                     pres_path)
    if "train-production-pipe" in only:
        train("train-production-pipe", rp(pcfg, **pipe), "production",
              pipe_path, capture=("pres_predict",))
    if "train-production-dense" in only:
        train("train-production-dense", rp(pcfg, **dense), "production",
              na_path, capture=("neighbor_attn",))
    if "train-production-apan" in only:
        train("train-production-apan", rp(pcfg, **apan), "production",
              na_path)
    if "train-production-rnn" in only:
        train("train-production-rnn", rp(pcfg, **rnn), "production",
              rnn_path, capture=("pres_filter",))
    if "train-production-jodie" in only:
        train("train-production-jodie", rp(pcfg, **jodie), "production",
              ("memory_update_table",))
    # 11. macro-batch training (T 8), each route's macro captured as a
    # CUDA graph: Alg. 2 (the memory_update_table kernel), Alg. 1 (the
    # gru_cell kernel) and the rnn cell with PRES (pres_filter); one
    # profiler session for all their epochs
    if "train-config-scan" in only:
        windows = []
        scans = (("train-config-scan", cfg, pres_path),
                 ("train-config-scan-std", rp(cfg, use_pres=False),
                  std_path),
                 ("train-config-scan-rnn", rp(cfg, **rnn), rnn_path))
        for label, c, expect in scans:
            train_sum[label] = timed(
                label, scan_phase, label, c, train_s, val_s, wiki_dst, dev,
                batch_size=500, expect=expect, captured=True,
                windows=windows)
        timed("train-config-scan-profile", _profile_windows, windows)
        for label, _, _ in scans:
            got = train_sum[label]
            for name in ("scan", "lag-one"):
                got[f"{name}_busy_share"] = \
                    PROFILES[f"{label}-{name}"]["busy_share"]
        side = lambda g: (f"events/s {g['scan_events_per_s']:.1f} / "
                          f"{g['lag-one_events_per_s']:.1f}, busy "
                          f"{100 * g['scan_busy_share']:.1f} / "
                          f"{100 * g['lag-one_busy_share']:.1f} %")
        for label, _, _ in scans:
            log(f"[{label}] captured / lag-one: {side(train_sum[label])} "
                f"(train-config-scan: "
                f"{side(train_sum['train-config-scan'])})")
    if "train-production-scan" in only:
        train_sum["train-production-scan"] = timed(
            "train-production-scan", production_scan_phase,
            "train-production-scan", pcfg, head, s_dst, dev,
            batch_size=1000, n_batches=41, expect=pres_path)
        got = train_sum["train-production-scan"]["step_ms"]
        lag = train_sum.get("train-production-pres", {})
        log(f"[train-production-scan] step ms {got:.3f} beside "
            f"train-production-pres's median {lag.get('step_ms_median')}")
    if "train-production-store" in only:
        # tgn_pres.PRODUCTION as published but for the store's node space
        # (1,200,000 where it names 1,048,576), its 32 edge features (172
        # named) and stream-10m cut to its first 1,000,000 events
        train_sum["train-production-store"] = timed(
            "train-production-store", store_phase, "train-production-store",
            rp(tgn_pres.PRODUCTION, use_kernels=True), dev,
            n_events=1_000_000, batch_size=1000, n_batches=41,
            expect=pres_path)
    if "cli-store" in only:
        train_sum["cli-store"] = timed("cli-store", cli_store_phase,
                                       "cli-store", pres_path)
    if "cli-obs" in only:
        train_sum["cli-obs"] = timed("cli-obs", cli_obs_phase, "cli-obs",
                                     card, pres_path, SERVE_KERNELS)

    # 12. memory-parallel training, every shard on this card: CONFIG at 1,
    # 2 and 4 shards (then 4 for the other engines and routes, and a tight
    # budget), PRODUCTION at 4 beside train-production-pres; bf16 tables
    bf16_rows = {}
    if "train-config-shards" in only:
        def shards(suffix, c, expect, ns=(1, 4), **kw):
            name = f"train-config-shards{suffix}"
            train_sum[name] = timed(
                name, shard_phase, name, c, train_s, val_s, wiki_dst, dev,
                batch_size=500, shards=ns, expect=expect, **kw)

        # budget 32 a lane: 1,000 occurrences a step over 4 senders and 4
        # owners load a lane with about 62
        shards("", cfg, pres_path, ns=(1, 2, 4), budget=32)
        shards("-pipe", rp(cfg, **pipe), pipe_path)
        shards("-apan", rp(cfg, **apan), na_path)
        # JODIE's raw-time projection moves its free-running epoch by more
        # than the limits under a rounding-sized perturbation (as in
        # train-config-jodie): held to the limits beyond that spread
        shards("-jodie", rp(cfg, **jodie), ("memory_update_table",),
               noise_floor=True)
        shards("-plain", rp(cfg, use_kernels=False), ())
        shards("-scan", rp(cfg, scan_chunk=8), pres_path, engine="scan")
    if "train-production-shard4" in only:
        train_sum["train-production-shard4"] = timed(
            "train-production-shard4", shard_production_phase,
            "train-production-shard4", pcfg, head, s_dst, dev,
            batch_size=1000, n_batches=41, n_shards=4, expect=pres_path)
        got = train_sum["train-production-shard4"]["step_ms_median"]
        lag = train_sum.get("train-production-pres", {})
        log(f"[train-production-shard4] step ms {got:.3f} beside "
            f"train-production-pres's median {lag.get('step_ms_median')}")
    if "train-config-bf16" in only:
        counts, inputs, train_sum["train-config-bf16"] = timed(
            "train-config-bf16", bf16_phase, "train-config-bf16", cfg,
            train_s, wiki_dst, dev, batch_size=500, n_batches=None,
            expect=pres_path)
        bf16_rows["config"] = (inputs, counts)
    if "train-production-bf16" in only:
        counts, inputs, train_sum["train-production-bf16"] = timed(
            "train-production-bf16", bf16_phase, "train-production-bf16",
            pcfg, head, s_dst, dev, batch_size=1000, n_batches=41,
            expect=pres_path)
        bf16_rows["production"] = (inputs, counts)
    if "cli-shards" in only:
        train_sum["cli-shards"] = timed(
            "train-cli-shards", cli_phase, "train-cli-shards",
            cli + ["--pres", "--n-shards", "4", "--device", "cuda:0"],
            pres_path)

    # 13. the distributed train spec (train/distributed.py) on a 1x1
    # DeviceMesh over an NCCL group of world 1, each step against the
    # single-device kernel step from the same carry
    def spec_run(label, c, expect, **kw):
        train_sum[label] = timed(label, spec_phase, label, c, train_s,
                                 wiki_dst, dev, batch_size=500,
                                 expect=expect, **kw)

    if "spec-mdgnn" in only:
        spec_run("spec-mdgnn", cfg, pres_path)
        spec_run("spec-mdgnn-std", rp(cfg, use_pres=False), std_path)
        # PRODUCTION widths at b 1,000, both steps timed
        got = train_sum["spec-mdgnn-production"] = timed(
            "spec-mdgnn-production", spec_phase, "spec-mdgnn-production",
            pcfg, head, s_dst, dev, batch_size=1000, expect=pres_path,
            time_it=True)
        log(f"[spec-mdgnn-production] {card}: ms a step single-device "
            f"{got['single_ms']:.3f}, spec {got['spec_ms']:.3f}")
    if "spec-mdgnn-compact" in only:
        spec_run("spec-mdgnn-compact", cfg, pres_path,
                 strategy="compact_update")
    if "spec-mdgnn-optimized" in only:
        # the JAX package's optimized bundle: every parameter and state
        # table replicated, events over all mesh axes, hashed trackers
        # (|V| / 16) and a bf16 table (the table kernel's bf16 entry)
        from repro_torch.nn import module as module_lib
        spec_run("spec-mdgnn-optimized",
                 rp(cfg, pres_buckets=cfg.n_nodes // 16,
                    mem_dtype="bfloat16"), pres_path, strategy="optimized",
                 rules=dict(module_lib.RULE_SETS["mdgnn_event_dp_repl"]))
    if "spec-mdgnn-pipe" in only:
        spec_run("spec-mdgnn-pipe", rp(cfg, **pipe), pipe_path)
    if "spec-mdgnn-scan" in only:
        # one macro step of 3 (the spec's scanned step) against the eager
        # macro step
        spec_run("spec-mdgnn-scan", rp(cfg, scan_chunk=3), pres_path)

    # 9. the model zoo at full width: prefill (the zoo's kernels) and
    # decode, then the decode CLI for every ported arch
    zoo_sum = {}
    for label in ZOO:
        if label in only:
            counts, inputs, zoo_sum[label] = timed(
                label, zoo_phase, label, dev, args.seed,
                profile=args.profile)
            for key, best in inputs.items():
                keep(ZOO[label][3], "zoo" if key in ZOO_LINE else key, best,
                     counts)
    # zoo training at full width, then each reduced arch
    train_zoo_sum = {}
    for label in TRAIN_ZOO:
        if label in only:
            train_zoo_sum[label] = timed(label, train_zoo_phase, label, dev,
                                         args.seed)
    if "train-zoo-reduced" in only:
        train_zoo_sum["train-zoo-reduced"] = timed(
            "train-zoo-reduced", train_zoo_reduced_phase,
            "train-zoo-reduced", dev, args.seed)
    # 14. the zoo's sharded specs on a 1x1 DeviceMesh, and the dry run
    for label in SPEC_ZOO:
        if label in only:
            train_zoo_sum[label] = timed(label, spec_zoo_phase, label, dev,
                                         args.seed)
    if "spec-zoo-fsdp" in only:
        train_zoo_sum["spec-zoo-fsdp"] = timed(
            "spec-zoo-fsdp", spec_zoo_fsdp_phase, "spec-zoo-fsdp", dev,
            args.seed)
    if "dryrun" in only:
        train_zoo_sum["dryrun"] = timed("dryrun", dryrun_phase, "dryrun")
    if "cli-zoo" in only:
        from repro_torch.configs import ARCH_IDS
        for arch in ARCH_IDS:
            zoo_sum[f"cli-zoo-{arch}"] = timed(
                f"cli-zoo-{arch}", cli_zoo_phase, f"cli-zoo-{arch}", arch,
                16)
    autotune_sum = {}
    if "autotune" in only:
        autotune_sum = timed("autotune", autotune_phase, "autotune", dev)

    # 10. kernels on the inputs their phases handed them: the rows of the
    # CONFIG phases and of ZOO_LINE's in the result line, the others'
    # (PRODUCTION, the other zoo phases) in --out and the log
    rows, more_rows, zoo_rows = [], [], []
    for name, spec_ in ops.REGISTRY.items():
        for phase, (inputs, counts) in captured.get(name, {}).items():
            row = kernel_row(name, spec_, phase, inputs, counts)
            (rows if phase in ("config", "zoo") else
             zoo_rows if phase.startswith("zoo-") else more_rows).append(row)
    for phase, (inputs, counts) in bf16_rows.items():
        row = kernel_row("memory_update_table",
                         ops.REGISTRY["memory_update_table"], phase, inputs,
                         counts, row_name="memory_update_table_bf16")
        (rows if phase == "config" else more_rows).append(row)
    for label, a, kw in bf16h:
        if label in ("bf16 h M=1000 D=100 Din=100",
                     "bf16 h M=2000 D=128 Din=128"):
            more_rows.append(kernel_row(
                "memory_update", ops.REGISTRY["memory_update"], "edge",
                {"memory_update": (None, a, kw)},
                {"memory_update": len(bf16h)},
                row_name="memory_update_bf16h"))
    if only == set(PHASES):
        names = sorted(ops.REGISTRY)
        want_zoo = sorted((k, key) for label, z in ZOO.items()
                          if label not in ZOO_LINE for k in z[3]
                          for key in ([label, f"{label}-local"] if z[4]
                                      else [label]))
        require(sorted(r["name"] for r in rows)
                == sorted(names + ["memory_update_table_bf16"])
                and sorted({r["name"] for r in more_rows})
                == sorted(set(names) - set(ZOO_KERNELS)
                          | {"memory_update_table_bf16",
                             "memory_update_bf16h"})
                and sorted((r["name"], r["phase"]) for r in zoo_rows)
                == want_zoo,
                f"kernel rows for {sorted(r['name'] for r in rows)} only")
    for run_profile in DEFERRED_PROFILES:
        run_profile()
    DEFERRED_PROFILES.clear()
    log(f"[seconds] {json.dumps(seconds)}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": rows, "more_kernel_rows": more_rows,
             "zoo_kernel_rows": zoo_rows,
             "serve": serve_sum, "train": train_sum, "zoo": zoo_sum,
             "train_zoo": train_zoo_sum, "autotune": autotune_sum,
             "profiles": PROFILES, "seconds": seconds},
            indent=1))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
