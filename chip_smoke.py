#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA GPU and check them.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version and times both (the
queue kernels bit for bit; flash attention and the SSD scan within a
stated tolerance, and beside ``scaled_dot_product_attention``).  The
single-pass FIFO, stack and tiered scans are also held at their tile's
edges, at 2^24 + 1 ops and over 2,000 back-to-back calls, and must run
one kernel per call by the profiler's kernel names (the tiered scan one
per group of 256 tiers, by the profiler and by its wrapper's count), as
must the hash route at the migrations' sizes (1 to 65,536 positions,
each twice in a row) and at 2^24; the
four queue kernels report their device ms per call from the
profiler beside the wrapper's CUDA-event ms, which at one wave is mostly
the host's.  The wave engine's Stage-4 commit kernel is held bit for bit
against its plain version on a 64- and a 48-shard wave of a real
dispatch (the pipelined path's strided view and a contiguous copy) and
timed beside it and its bytes bound.  Then it drives the port through its entry points at full
size:

* the elastic FIFO queue (64 shards x 65,536 slots x 4 int32 words), the
  elastic LIFO stack (64 shards x 32,768 slots x depth 4), the elastic
  4-tier priority queue (64 shards x 16,384 slots per tier) and the
  elastic Seap queue (64 shards x 8 buckets x 16,384 slots, EDF
  deadlines whose slack drifts, splits and on-demand merges of its
  directory), each to a backlog above 1,000,000 elements, a LEAVE of 16
  of 64 shards, a JOIN back and a drain to ⊥, plus a small relaxed
  priority queue (8 -> 6 shards) through the hash-route report, a
  300-tier priority queue (4 -> 6 -> 4 shards) and a Seap queue with keys
  at both int32 edges (8 -> 6 -> 8 shards), each on the card against the
  same waves on the CPU, and op by op against the port's host oracles
  (``PriorityOracle``, ``SeapOracle``);
* the paper's protocol (the port's ``Skueue``, host code) at Fig. 4's
  full setting, 1,024 processes at 1.0 requests per virtual node per
  round for 120 rounds, in queue mode and in stack mode with local
  combining, through 32 JOINs and 16 LEAVEs (the anchor's process among
  them) to quiescence, checked by the port's consistency checker; then
  its total order replayed through the elastic FIFO queue and stack on
  the card (64 -> 48 -> 64 shards), every position, ⊥ flag and dequeued
  element the protocol's; and ``synthetic_tokens`` on the card against
  the CPU at the prefill's shape;
* the prefill of zamba2-1.2b at full width and depth (random weights
  from the seed): 4 prompts of 4,096 tokens through 6 flash-attention
  calls (all on the tensor-core kernel) and 38 SSD-scan calls (three
  launches each), a 512-token prompt against teacher-forced decoding,
  and, cut to 6 layers, a bf16 prefill on the card against the same
  prefill on the CPU;
* the FIFO serving engine over an 8-shard request queue serving 32
  requests with the same model, resized 8 -> 6 between two bursts; the
  EDF engine (the Seap queue, deferral and an autoscaler) serving 32
  requests, loose deadlines then tight ones, resized 8 -> 6 between
  them; and the tier engine (4 tiers, relaxation 1) serving 16;
* the relaxed tier resolution: its kernel against the plain host loop
  bit for bit (full waves at 4, 300 and 1,000 tiers, all ⊥, heads that
  wrap at INT32_MAX mid-pass, 100 shards), its clock build's passes and
  events against the walk model's and its cycles a step, and the
  64-shard priority queue with relaxation 1 at full width (one relaxed
  launch a wave) to a backlog above 1,000,000 through a LEAVE and a
  JOIN, beside the strict path's waves/s;
* Wavescope: the FIFO, priority and Seap queues at full size with the
  metrics ring, every row against the checked outputs, waves/s with the
  ring on and off in turns; ``python -m repro_torch.obs --smoke``; the
  FIFO serving run's first burst again with ``telemetry=True`` (one row
  per queue wave, the Prometheus text parsed);
* a 64-shard FIFO queue with a backlog above 1,000,000 saved, restored
  at 48 shards and drained in order; ``run_with_restarts`` over elastic
  FIFO bursts through a shard failure (LEAVE, quarantine, regrow JOIN)
  and a whole-job failure (restart from the latest checkpoint);
* the five-exchange seed wave (``DeviceQueue(fused=False)``) against the
  fused wave on the same full-width waves;
* ``WorkQueue`` over the FIFO configuration (64 workers, leases of 8
  steps, bursts of 9 waves) filled above 1,000,000 and drained, its
  grants, retries and stats against a host model of the lease protocol;
  the elastic FIFO queue on a ``SimRuntime`` with a scheduled shard
  failure under ``run_with_restarts`` (LEAVE, regrow JOIN), its modelled
  wire time against the formula over the counted launches and bytes;
  and the FIFO, LIFO, priority (strict and relaxation 1) and Seap
  configurations in two processes sharing the card (``launch_localhost``,
  a ``DistributedRuntime`` of 32 shards each, gloo on CUDA tensors)
  through a LEAVE and a JOIN that interleave the processes' shards, each
  process checking every burst against the host model, its exchange
  budget and its kernels' launches (one tiered launch a wave, one relaxed
  launch a wave on the relaxed path); and the EDF serving run again in
  two processes (4 of its 8 queue shards each, zamba2-1.2b from the same
  seed in both), its admission order, served requests and deadline
  misses against the one-process run's, its tokens equal in the two
  processes (this script re-run with ``--dist-child``);
* wavecheck in torch terms (``repro_torch.analysis.run_all``) at the
  queue cells' full width, 64 shards x 1,024 ops and bursts of 16: the 43
  wave programs of the four disciplines (steps, sequential and pipelined
  bursts, the metrics ring, the ladder widths 256 and 512; the priority
  programs with relaxation 1), the seed wave, two ``SimRuntime`` twins
  and the four migrations, each call's exchanges and gathers counted at
  the runtime seam against its budget, its store held in place and a
  migration's old store released; the rebuild bounce at 64 shards on a
  pool of 80 (JOIN 16, LEAVE 16) rebuilding nothing the second time; the
  int32 and AST lints; then the four remaining examples on the card,
  the queue examples' lines against the same runs on the CPU, beside
  ``python -m repro_torch.analysis --all`` and ``--selftest`` at 8
  shards;
* training: the flash-attention backward kernels (the wgmma route for
  bf16 at D 64 and 128) and the SSD scan's backward kernel against their
  plain versions at the training shape and others, two calls bit for
  bit; zamba2-1.2b at full width and depth
  trained through ``make_train_step`` (8 x 4,096 tokens from
  ``GlobalOrderPipeline`` as 2 microbatches, remat, AdamW) for 3 steps,
  every forward and backward launch counted against the model and no
  plain version run, one step profiled; at 6 layers, one f32 step on
  the card against the CPU (and the bf16 step, reported); and
  ``train_loop`` for 120 steps through a failure and a restart from a
  checkpoint, the replayed steps' losses bit for bit;
* the moe, vlm and encdec families: flash attention forward and backward
  held at their shapes (whisper-small's bidirectional encoder over 1,500
  frames, its 448 x 1,500 cross-attention, 4,096 queries against 1,500
  unmasked keys, granite-moe's G 2, llava's G 7 at D 128); granite-moe-1b
  at full width and depth (24 layers, 32 experts, top-8) prefilling 4 x
  4,096 tokens (the share of dropped choices reported), its f32 prefill
  at 2 layers on the card against the CPU (chosen experts compared
  first, every differing token reported with its margin), FIFO serving
  of 16 requests and 3 training steps (8 x 4,096 tokens, 2
  microbatches; the aux loss in the loss); whisper-small at full size
  prefilling 8 x (1,500 frames, 448 tokens), 2 + 2 layers on the card
  against the CPU, and 3 training steps; llava-next-34b at published
  widths cut to 8 layers prefilling 2 x (2,880 vision, 1,216 text)
  positions, its loss on the text slice, and 2 layers on the card
  against the CPU.  Every flash launch of these paths is counted
  against what the model implies, all on the tensor-core routes.

Each is checked against a host model written here (order, ⊥ counts,
overflow, migration counts, the exchange budget, the kernels' launch
counts, FIFO, tier and EDF admission; the Seap model follows the
semantics stated in ``repro/core/seap.py`` and imports nothing of the
JAX package) and the queues' pipelined bursts against the sequential
schedule.  One JSON line per phase; the line before the last
lists the kernels, the last line is the result.  Any failed check
raises, and the exit code is then not 0.  Without a CUDA device, or
outside a checkout, it fails before printing anything.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
MEM_BPS = 3.35e12      # H100 SXM device memory rate, bytes/s
# H100 SXM INT32 rate outside the tensor cores, operations/s: 64 INT32
# lanes per SM (NVIDIA H100 Tensor Core GPU Architecture whitepaper) x 132
# SMs x 1.98 GHz boost (the clock behind the data sheet's 67 TFLOP/s FP32)
INT_OPS = 64 * 132 * 1.98e9
BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate (data sheet)
F32_FLOPS = 67e12      # H100 SXM f32 rate outside the tensor cores
# f32 products on the TF32 tensor cores (495 TFLOP/s dense, data sheet) as
# 3xTF32, three tf32 products each: the SSD kernel's rate for them
F32_3XTF32_FLOPS = 495e12 / 3
# flash attention vs its plain version, per element: |got - want| <=
# FLASH_RTOL |want| + FLASH_ATOL.  Both compute in f32 and round the output
# to bf16 once, so they sit at most one bf16 step apart (2^-7 of |want|),
# plus the two f32 summation orders' difference where |want| is near 0
# (each line reports it as ``beyond_one_step``; PERF.md gives the
# readings).  f32 outputs: FLASH_F32_TOL absolute, summation order only.
FLASH_RTOL = 2.0 ** -7
FLASH_ATOL = 1e-5
FLASH_F32_TOL = 2e-5
# SSD scan vs its plain version, both f32: summation order through the
# carried state, relative to max |y|
SSD_REL_TOL = 1e-4
# zamba2-1.2b last-token logits, prefill (kernels) vs teacher-forced
# decode (no kernel), both in f32: the two orders of summation differ by
# about 1e-6 per op (tests/test_torch_models.py holds reduced configs to
# 1e-4), and 44 blocks of random weights amplify a perturbation many
# times over; 1e-2 leaves room above that.  In bf16 the gap is the two
# paths' rounding, amplified the same way: reported, not gated, beside
# each bf16 path's distance from the f32 prefill.  The JAX package shows
# a gap of the same size on the same weights
# (scripts/prefill_decode_gap.py; PERF.md).
PREFILL_DECODE_TOL = 1e-2
# zamba2-1.2b at full width cut to CARD_CPU_LAYERS layers (one call of the
# shared attention block), CARD_CPU_DRAWS draws of random weights, two
# bf16 prompts of CARD_CPU_TOKENS tokens each (no multiple of the
# 128-query tile or the 64-token chunk): the prefill on the card (the
# tensor-core flash kernel, the SSD kernel, cuBLAS) against the same
# weights on the CPU (the kernels' plain versions).  The two round to
# bf16 at other places, so their last-token logits (max |logit| about 4)
# differ by about as much as each differs from the CPU's f32 prefill:
# 0.0859375, 0.078125 and 0.1875 on an NVIDIA H100 80GB HBM3 at 700 W
# (seeds 0-2); CARD_CPU_TOL is about twice the largest.
CARD_CPU_LAYERS = 6
CARD_CPU_TOKENS = 1000
CARD_CPU_DRAWS = 3
CARD_CPU_TOL = 0.4
# flash attention's backward kernel vs its plain backward, per element of
# dq, dk, dv: |got - want| <= FLASH_BWD_RTOL |want| + FLASH_BWD_ATOL_REL
# max|want|.  Both compute in f32 (the kernel's P and dS enter the tensor
# cores as bf16 hi + lo parts, about f32's accuracy) and round each
# gradient to bf16 once: one bf16 step, plus the two f32 summation
# orders' difference over up to Lq terms, which shows where |want| is near
# 0 (tests/test_torch_flash_attention.py emulates the kernel's arithmetic
# on the CPU within this limit).  f32 inputs: FLASH_BWD_F32_REL of
# max|want|, summation order only.
FLASH_BWD_RTOL = 2.0 ** -7
FLASH_BWD_ATOL_REL = 2.0 ** -10
FLASH_BWD_F32_REL = 1e-5
# the SSD scan's backward kernel vs the plain backward (three chunked
# scans), f32: summation order through the carried states, and for dloga
# a reverse cumulative sum over L of differences; relative to each
# gradient's max
SSD_BWD_REL = 1e-4
# zamba2-1.2b at full width cut to TRAIN_CPU_LAYERS layers (one shared
# block call), f32 weights, TRAIN_CPU_BATCH x TRAIN_CPU_TOKENS tokens: one
# train step on the card (kernels, TF32 off) against the CPU (plain
# versions).  Both are f32 in other summation orders (cuBLAS, the SSD
# kernel's 3xTF32, the flash kernels' tiles), amplified through 7 blocks
# of random weights: the loss within TRAIN_CPU_LOSS_TOL, each gradient
# leaf and each leaf of AdamW's first moment (0.1 times the clipped
# gradient) within TRAIN_CPU_GRAD_REL (relative Frobenius error).  The
# updated parameters are held within TRAIN_CPU_STEP_LR learning rates,
# which catches a wrong step (NaN, a wrong learning rate, weight decay or
# cast) but never a wrong gradient: AdamW's first step moves an element
# by at most lr whatever its gradient, so the two sides are never more
# than 2·lr apart; the moments carry the gradient.  Readings on an
# NVIDIA H100 80GB HBM3 at 700 W (seed 0): loss 9.5e-7 (one f32 step of 10.8); gradients
# 7.9e-4 (A_log) and 7.3e-4 (dt_bias), which sum dloga, itself a reverse
# cumulative sum of differences, over every token, and at most 3.7e-5
# elsewhere; first moments 7.9e-4 (A_log); updated parameters 1.17 lr.
# Each bound is about 2.5 times its reading (ten f32 steps for the loss).
TRAIN_CPU_LAYERS = 6
TRAIN_CPU_BATCH = 2
TRAIN_CPU_TOKENS = 512
TRAIN_CPU_LOSS_TOL = 1e-5
TRAIN_CPU_GRAD_REL = 2e-3
TRAIN_CPU_STEP_LR = 2.5
# path:train_zamba2: global batches of TRAIN_BATCH x TRAIN_SEQ tokens as
# TRAIN_MICRO microbatches, TRAIN_STEPS steps (train_4k's global batch of
# 256 cut to 8 for one card); path:train_loop at TRAIN_CPU_LAYERS layers
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_FAIL_AT = 120, 40, 60
# path:train_zamba2's peak device memory may not grow past the three-scan
# SSD backward's (42,975,595,008 bytes on an NVIDIA H100 80GB HBM3 at
# 700 W) plus 1 GB
TRAIN_PEAK_BYTES = 42_975_595_008 + 1_000_000_000
LOOP_BATCH, LOOP_SEQ = 8, 1_024
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 4_096, 2, 3
TRAIN_REDUCED = "train_4k's global batch of 256 cut to 8 (one card)"
# the moe, vlm and encdec paths.  granite-moe-1b: prefill batch x tokens;
# its card-vs-CPU check at 2 layers (full width) on MOE_CPU_TOKENS in f32
# with TF32 off, the chosen experts compared first: a token whose top-8
# set differs must be a near tie (its CPU margin between the 8th and 9th
# probabilities at most MOE_FLIP_MARGIN, where f32 summation orders can
# flip it).  whisper-small: WHISPER_PREFILL_BATCH sequences of 1,500
# frames and WHISPER_TEXT tokens (Whisper's text context); llava-next-34b
# cut to LLAVA_LAYERS layers, 2 sequences of 2,880 vision embeddings and
# LLAVA_TEXT tokens (4,096 positions, the reference's train_4k split); its
# CPU check on LLAVA_CPU = (vision, text) positions.  The card-vs-CPU
# logits (f32, TF32 off: summation orders only) within *_CPU_TOL, about
# three times the readings on an NVIDIA H100 80GB HBM3 at 700 W (seed 0):
# granite-moe 5.2e-6 (max |logit| 3.0), whisper 3.7e-5 (2.4), llava
# 6.9e-5 (7.4).
MOE_PREFILL, MOE_CPU_TOKENS = (4, 4_096), (2, 512)
MOE_CPU_TOL, MOE_FLIP_MARGIN = 2e-5, 1e-5
WHISPER_PREFILL_BATCH, WHISPER_TEXT, WHISPER_CPU_TOL = 8, 448, 1e-4
LLAVA_LAYERS, LLAVA_TEXT, LLAVA_CPU, LLAVA_CPU_TOL = 8, 1_216, (576, 448), 2e-4
SCAN_OPS = 20          # int ops per op: transform, ~2 composes, emission
HASH_OPS = 12          # int ops per element: splitmix32, shift, modulo
TIER_OPS = 10          # int ops per op: key, warp match, rank, emission
CARD = ""              # "name, power limit" from nvidia-smi, set in main()
T0 = time.perf_counter()  # each phase line's t_s: seconds since the start
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD,
                      "t_s": time.perf_counter() - T0, **fields}),
          flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def time_ms(fn, reps: int, torch, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, peak: float = INT_OPS) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (INT32 by default)."""
    t_b, t_o = n_bytes / MEM_BPS * 1e3, n_ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


# ----------------------------------------------------------------- phases --
def phase_build():
    """Build every kernel library from csrc/ (one nvcc each, in parallel)
    and report each kernel's registers, static shared memory and spills
    from ptxas, and the dynamic shared memory of the two model kernels at
    the prefill path's shapes."""
    import ctypes
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    info = backend.build()
    total = time.perf_counter() - t0
    kernels = {}
    for name, rec in info.items():
        fns, cur, spill = [], None, (0, 0)
        for line in rec["ptxas"].splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                cur = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                fns.append({"function": cur, "registers": int(m.group(1)),
                            "smem_bytes": int(smem.group(1)) if smem else 0,
                            "spill_stores": spill[0],
                            "spill_loads": spill[1]})
                spill = (0, 0)
        # ptxas performance notices, e.g. C7512 / C7518: wgmma serialized
        notices = [line.strip() for line in rec["ptxas"].splitlines()
                   if "Performance Loss" in line]
        kernels[name] = {"seconds": rec["seconds"], "cached": rec["cached"],
                         "functions": fns, "ptxas_notices": notices}
    libs = {name: backend.load(name) for name in info}
    fa = libs["flash_attention"].repro_flash_attention_tc_smem
    fa.argtypes, fa.restype = [ctypes.c_int], ctypes.c_int64
    ssd = libs["ssd_scan"].repro_ssd_scan_smem
    ssd.argtypes, ssd.restype = [ctypes.c_int] * 3, ctypes.c_int64
    ssd_bwd = libs["ssd_scan_bwd"].repro_ssd_scan_bwd_smem
    ssd_bwd.argtypes, ssd_bwd.restype = [ctypes.c_int] * 3, ctypes.c_int64
    from repro_torch.kernels.ssd_scan.kernel import CHUNK
    dynamic = {"flash_fwd_wgmma<64>": fa(64),
               "flash_fwd_wgmma<128>": fa(128),
               f"ssd_scan (P = N = 64, chunk {CHUNK}, bf16 B/C)":
               ssd(64, 64, 1),
               "ssd_scan_bwd_chunk (P = N = 64, bf16 B/C)": ssd_bwd(64, 64, 1)}
    emit("build", seconds=total, kernels=kernels,
         dynamic_smem_bytes=dynamic)
    for name, rec in kernels.items():
        if name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                    "ssd_scan_bwd"):
            for f in rec["functions"]:
                print(f"ptxas {name}: {f['function']}: {f['registers']} "
                      f"registers, {f['smem_bytes']} bytes static smem, "
                      f"spills {f['spill_stores']}/{f['spill_loads']} bytes",
                      flush=True)
            for note in rec["ptxas_notices"]:
                print(f"ptxas {name}: {note}", flush=True)
    return kernels


def _ptxas_of(build, library: str, pattern: str) -> dict:
    """{kernel<template args>: {registers, spill_stores, spill_loads}} of the
    build phase's ptxas report for the functions of ``library`` whose
    mangled names match ``pattern``: group 1 the name, later groups its
    template arguments (bf16 and f32 written out)."""
    types = {"13__nv_bfloat16": "bf16", "f": "f32"}
    out = {}
    for f in build[library]["functions"]:
        m = re.search(pattern, f["function"] or "")
        if m:
            args = [types.get(a, a) for a in m.groups()[1:] if a]
            key = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            out[key] = {k: f[k] for k in ("registers", "spill_stores",
                                           "spill_loads")}
    return out


def phase_queue_scan(torch, rng, results):
    """The FIFO scan at its tile's edges, one wave, 2^24 and 2^24 + 1, in
    three mixes and three states (the last near 2^29, where INF + last
    nears 2^31), against its plain version; timed at one wave and 2^24."""
    from repro_torch.kernels.segscan import queue_scan, queue_scan_ref
    dev = torch.device("cuda")
    mixes = {"enq65": (0.65, 1.0), "deq_only": (0.0, 1.0),
             "valid80": (0.5, 0.8)}
    states = [(0, -1), (1_000_000, 1_005_000), (2 ** 29 - 3000, 2 ** 29)]
    for n in _scan_sizes():
        worst, launches0 = 0, queue_scan.launches
        for mix, (p_enq, p_valid) in mixes.items():
            e = torch.from_numpy(rng.random(n) < p_enq).to(dev)
            v = torch.from_numpy(rng.random(n) < p_valid).to(dev)
            for f, l in states:
                f_t = torch.tensor(f, dtype=torch.int32, device=dev)
                l_t = torch.tensor(l, dtype=torch.int32, device=dev)
                want = queue_scan_ref(e, v, f_t, l_t)
                got = queue_scan(e, v, f_t, l_t)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"queue_scan n={n} {mix} state={(f, l)} "
                      f"bit-identical to its plain version")
                worst = max(worst, max_abs_err(got, want))
        rec = {"n": n, "mixes": list(mixes), "states": states,
               "bit_identical": True,
               "max_abs_err": worst,
               "launches": queue_scan.launches - launches0}
        if n in TIMED_N:
            # the main-path mix from the empty queue
            e = torch.from_numpy(rng.random(n) < 0.65).to(dev)
            v = torch.ones(n, dtype=torch.bool, device=dev)
            f_t = torch.tensor(0, dtype=torch.int32, device=dev)
            l_t = torch.tensor(-1, dtype=torch.int32, device=dev)
            ms, plain = _time_pair(
                torch, lambda: queue_scan(e, v, f_t, l_t),
                lambda: queue_scan_ref(e, v, f_t, l_t))
            b_ms, b_by = bound(7 * n + 16, SCAN_OPS * n)
            rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        results[("queue_scan", n)] = rec
        emit("kernel:queue_scan", **rec)


def phase_hash_route(torch, rng, results):
    from repro_torch.kernels.hash_route import hash_route, hash_route_ref
    dev = torch.device("cuda")
    n = 16_777_216
    base = int(rng.integers(-2 ** 31, 2 ** 31))
    pos = torch.from_numpy(((base + np.arange(n, dtype=np.int64) + 2 ** 31)
                            % 2 ** 32 - 2 ** 31).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for n_shards in (48, 64):
        launches0 = hash_route.launches
        got = hash_route(pos, valid, n_shards)
        want = hash_route_ref(pos, valid, n_shards)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(got, want))
        check(identical,
              f"hash_route n={n} n_shards={n_shards} identical to plain")
        ms = time_ms(lambda: hash_route(pos, valid, n_shards), 100, torch)
        plain = time_ms(lambda: hash_route_ref(pos, valid, n_shards), 20,
                        torch)
        b_ms, b_by = bound(9 * n + 4 * n_shards, HASH_OPS * n)
        rec = {"n": n, "n_shards": n_shards, "base": base,
               "identical": identical, "max_abs_err": max_abs_err(got, want),
               "launches": hash_route.launches - launches0, "ms": ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        results[("hash_route", n, n_shards)] = rec
        emit("kernel:hash_route", **rec)
    # the migrations' sizes: n = 1 and 1,024 (one launch's floor), 39,102
    # (hash_balance's live set at seed 0) and 65,536 (the largest a path
    # migrates), each against its plain version twice in a row (anything
    # a call left behind would show in the second) and timed beside the
    # bytes bound; their device ms come with the profiled phases
    # (phase_scan_device_split)
    floor = {}
    for n in HASH_FLOOR_N:
        p = pos[:n].clone()
        va = valid[:n].clone()
        want = hash_route_ref(p, va, 64)
        for _ in range(2):
            got = hash_route(p, va, 64)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"hash_route n={n} n_shards=64 identical to plain")
        b_ms, b_by = bound(9 * n + 4 * 64, HASH_OPS * n)
        floor[n] = {"ms": time_ms(lambda: hash_route(p, va, 64), 100, torch),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "max_abs_err": max_abs_err(got, want)}
    results["hash_route_floor"] = floor


def _time_pair(torch, kernel, plain):
    """(kernel ms, plain ms) of one call each, by CUDA events."""
    return time_ms(kernel, 100, torch), time_ms(plain, 20, torch)


# The single-pass scans (stack, tiered) are checked at their tile's edges
# and at 2^24 + 1 (a ragged last tile at full size) beside the sizes they
# are timed at: one wave and 2^24.
TIMED_N = (65_536, 16_777_216)
HASH_FLOOR_N = (1, 1_024, 39_102, 65_536)   # hash_route at migrations' n


def _scan_sizes():
    from repro_torch.kernels.segscan.kernel import TILE
    return (TILE - 1, TILE + 1, *TIMED_N, TIMED_N[1] + 1)


def phase_stack_scan(torch, rng, results):
    from repro_torch.kernels.segscan import stack_scan, stack_scan_ref
    dev = torch.device("cuda")
    mixes = {"push65": (0.65, 1.0), "pop_only": (0.0, 1.0),
             "push_only": (1.0, 1.0), "valid80": (0.5, 0.8)}
    states = [(0, 0), (1_000_000, 5_000_000)]
    for n in _scan_sizes():
        worst, launches0 = 0, stack_scan.launches
        for mix, (p_push, p_valid) in mixes.items():
            e = torch.from_numpy(rng.random(n) < p_push).to(dev)
            v = torch.from_numpy(rng.random(n) < p_valid).to(dev)
            for last, tick in states:
                a = torch.tensor(last, dtype=torch.int32, device=dev)
                b = torch.tensor(tick, dtype=torch.int32, device=dev)
                got = stack_scan(e, v, a, b)
                want = stack_scan_ref(e, v, a, b)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"stack_scan n={n} {mix} state={(last, tick)} "
                      f"bit-identical to its plain version")
                worst = max(worst, max_abs_err(got, want))
        rec = {"n": n, "mixes": list(mixes), "states": states,
               "bit_identical": True, "max_abs_err": worst,
               "launches": stack_scan.launches - launches0}
        if n in TIMED_N:
            e = torch.from_numpy(rng.random(n) < 0.65).to(dev)
            v = torch.ones(n, dtype=torch.bool, device=dev)
            a = torch.tensor(500_000, dtype=torch.int32, device=dev)
            b = torch.tensor(700_000, dtype=torch.int32, device=dev)
            ms, plain = _time_pair(torch, lambda: stack_scan(e, v, a, b),
                                   lambda: stack_scan_ref(e, v, a, b))
            b_ms, b_by = bound(11 * n + 16, SCAN_OPS * n)
            rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        results[("stack_scan", n)] = rec
        emit("kernel:stack_scan", **rec)


def phase_tiered_scan(torch, rng, results):
    from repro_torch.kernels.segscan import (tiered_queue_scan,
                                             tiered_queue_scan_ref)
    from repro_torch.kernels.segscan.kernel import MAX_TIERS
    dev = torch.device("cuda")
    # (enqueue share, valid share, out-of-range tiers)
    mixes = {"enq_only": (1.0, 1.0, False), "deq_only": (0.0, 1.0, False),
             "valid80_out_of_range": (0.65, 0.8, True)}
    n_tiers = (1, 4, 64, 256, 257, 512)     # past 256: one launch a group
    for n in _scan_sizes():
        worst, launches0, per_call = 0, tiered_queue_scan.launches, {}
        for P in n_tiers:
            at_p = tiered_queue_scan.launches
            firsts = torch.from_numpy(rng.integers(0, 1000, P).astype(
                np.int32)).to(dev)
            lasts = firsts + 500
            for mix, (p_enq, p_valid, wide) in mixes.items():
                enq = torch.from_numpy((rng.random(n) < p_enq)
                                       & (rng.random(n) < p_valid)).to(dev)
                lo, hi = (-1, P + 1) if wide else (0, P)
                tier = torch.from_numpy(rng.integers(lo, hi, n).astype(
                    np.int32)).to(dev)
                got = tiered_queue_scan(enq, tier, firsts, lasts, P)
                want = tiered_queue_scan_ref(enq, tier, lasts)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"tiered_queue_scan n={n} P={P} {mix} bit-identical "
                      f"to its plain version")
                worst = max(worst, max_abs_err(got, want))
            per_call[P] = (tiered_queue_scan.launches - at_p) / len(mixes)
            check(per_call[P] == -(-P // MAX_TIERS),
                  f"tiered_queue_scan n={n} P={P}: one launch per group of "
                  f"{MAX_TIERS} tiers, got {per_call[P]} a call")
        rec = {"n": n, "n_tiers": list(n_tiers), "mixes": list(mixes),
               "kernels_per_call": per_call,
               "bit_identical": True, "max_abs_err": worst,
               "launches": tiered_queue_scan.launches - launches0}
        if n in TIMED_N:
            # the priority path's shape: 4 tiers, 65% enqueues, 40/30/20/10
            enq = torch.from_numpy(rng.random(n) < 0.65).to(dev)
            tier = torch.from_numpy(rng.choice(4, n, p=[0.4, 0.3, 0.2, 0.1])
                                    .astype(np.int32)).to(dev)
            firsts = torch.zeros(4, dtype=torch.int32, device=dev)
            lasts = torch.full((4,), 200_000, dtype=torch.int32, device=dev)

            def call():
                return tiered_queue_scan(enq, tier, firsts, lasts, 4)
            ms, plain = _time_pair(
                torch, call, lambda: tiered_queue_scan_ref(enq, tier, lasts))
            b_ms, b_by = bound(9 * n + 8 * 4, TIER_OPS * n)
            rec.update(timed_n_tiers=4, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by)
        results[("tiered_queue_scan", n)] = rec
        emit("kernel:tiered_queue_scan", **rec)


def phase_scan_host_split(torch, rng, results):
    """The three scan wrappers at one wave (65,536 ops), timed in turns
    (FIFO, stack, tiered; five rounds of 200 calls each, the median
    round per wrapper) by CUDA events: with the device's few us per call,
    this is the host's issue time, so the turns keep the host's noise
    alike for all three.  Their device ms: ``phase_scan_device_split``."""
    from repro_torch.kernels.segscan import (queue_scan, stack_scan,
                                             tiered_queue_scan)
    dev = torch.device("cuda")
    n = TIMED_N[0]
    e = torch.from_numpy(rng.random(n) < 0.65).to(dev)
    v = torch.ones(n, dtype=torch.bool, device=dev)
    tier = torch.from_numpy(rng.choice(4, n, p=[0.4, 0.3, 0.2, 0.1])
                            .astype(np.int32)).to(dev)
    lasts = torch.full((4,), 200_000, dtype=torch.int32, device=dev)
    a = torch.tensor(0, dtype=torch.int32, device=dev)
    b = torch.tensor(-1, dtype=torch.int32, device=dev)
    calls = {"queue_scan": lambda: queue_scan(e, v, a, b),
             "stack_scan": lambda: stack_scan(e, v, a, b),
             "tiered_queue_scan": lambda: tiered_queue_scan(
                 e, tier, lasts, lasts, 4)}
    rounds = {k: [] for k in calls}
    for _ in range(5):
        for k, fn in calls.items():
            rounds[k].append(time_ms(fn, 200, torch))
    rec = {k: {"wrapper_ms_median": float(np.median(r)),
               "wrapper_ms_rounds": r} for k, r in rounds.items()}
    results["scan_host_split"] = rec
    emit("kernel:scan_host_split", n=n, **rec)


def phase_scan_back_to_back(torch, results):
    """2,000 FIFO, stack and tiered calls in turn, queued back to back
    with no sync between them (they share the stream's look-back status
    buffer), n and inputs changing every call, then each checked against
    its plain version: a flag left from an earlier call, or an epoch that
    did not move, would show here."""
    from repro_torch.kernels.segscan import (queue_scan, queue_scan_ref,
                                             stack_scan, stack_scan_ref,
                                             tiered_queue_scan,
                                             tiered_queue_scan_ref)
    from repro_torch.kernels.segscan.kernel import TILE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    sizes = torch.randint(1, 6 * TILE, (2000,), generator=gen,
                          device=dev).tolist()
    plain = {"fifo": queue_scan_ref, "stack": stack_scan_ref,
             "tiered": tiered_queue_scan_ref}
    runs = []
    for k, n in enumerate(sizes):
        e = torch.rand(n, generator=gen, device=dev) < 0.6
        if k % 3 == 1:
            P = 8 if k % 2 else 24
            tier = torch.randint(-1, P + 1, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
            lasts = torch.randint(0, 100, (P,), generator=gen, device=dev,
                                  dtype=torch.int32)
            runs.append(("tiered", (e, tier, lasts), tiered_queue_scan(
                e, tier, lasts, lasts, P)))
            continue
        v = torch.rand(n, generator=gen, device=dev) < 0.9
        if k % 3 == 2:
            args = (e, v, torch.tensor(k, dtype=torch.int32, device=dev),
                    torch.tensor(k + n // 3, dtype=torch.int32, device=dev))
            runs.append(("fifo", args, queue_scan(*args)))
        else:
            args = (e, v, torch.tensor(k, dtype=torch.int32, device=dev),
                    torch.tensor(3 * k, dtype=torch.int32, device=dev))
            runs.append(("stack", args, stack_scan(*args)))
    torch.cuda.synchronize()
    for kind, args, got in runs:
        check(all(torch.equal(x, y) for x, y in zip(got, plain[kind](*args))),
              f"back-to-back {kind} call with n={args[0].shape[0]} "
              f"bit-identical to its plain version")
    rec = {"calls": len(runs), "n_range": [1, 6 * TILE - 1],
           "calls_by_scan": {k: sum(r[0] == k for r in runs) for k in plain},
           "bit_identical": True}
    results["scan_back_to_back"] = rec
    emit("kernel:scan_back_to_back", **rec)


def _payload(ids: np.ndarray) -> np.ndarray:
    """Payload words of op ``ids``: word 0 is the id, words 1-3 are mixes
    of it, so a dequeued element can be checked whole on the host."""
    u = ids.astype(np.uint64)
    words = [u, (u * 2654435761) & 0xFFFFFFFF, (u ^ 0x5BD1E995) + 7,
             (u * 40503 + 1) & 0xFFFFFFFF]
    return np.stack([w.astype(np.uint32).view(np.int32) for w in words], -1)


class FifoChecker:
    """Host-side FIFO model: expected dequeue ids and ⊥ set per burst,
    from numpy arithmetic independent of the code under test."""

    def __init__(self):
        self.expected = deque()      # arrays of enqueued ids, in order
        self.size = 0
        self.next_id = 0
        self.n_enq = self.n_deq = 0  # positions handed out so far

    @property
    def pending(self) -> int:
        return sum(b.size for b in self.expected)

    def stage(self, K: int, nL: int, p_enq: float, rng):
        E = rng.random((K, nL)) < p_enq
        V = np.ones((K, nL), bool)
        ids = np.arange(self.next_id, self.next_id + K * nL, dtype=np.int64)
        self.next_id += K * nL
        return E, V, _payload(ids).reshape(K, nL, 4)

    def verify(self, E, V, P, pos, m, dv, dok, ovf):
        e, v = E.reshape(-1), V.reshape(-1)
        deq = v & ~e
        # reflected walk: a dequeue is ⊥ exactly when the queue is empty
        step = np.where(v & e, 1, np.where(deq, -1, 0))
        walk = self.size + np.cumsum(step)
        floor = np.maximum.accumulate(np.maximum(-walk, 0))
        prev = np.concatenate([[0], floor[:-1]])
        bottom = deq & (floor > prev)
        m, dok, pos = m.reshape(-1), dok.reshape(-1), pos.reshape(-1)
        check(not ovf.any(), "no overflow")
        check(np.array_equal(m, v & ~bottom), "⊥ set matches the FIFO model")
        check(np.array_equal(dok, deq & ~bottom),
              "every matched dequeue found its element (none lost)")
        n_deq = int(dok.sum())
        got_ids = dv.reshape(-1, 4)[dok]
        enq_ids = P.reshape(-1, 4)[v & e, 0].astype(np.int64)
        # expected dequeue ids: the queue's head, then this burst's enqueues
        # (a same-burst dequeue may take an element enqueued before it)
        self.expected.append(enq_ids)
        head = []
        need = n_deq
        while need:
            blk = self.expected[0]
            take = min(need, blk.size)
            head.append(blk[:take])
            if take == blk.size:
                self.expected.popleft()
            else:
                self.expected[0] = blk[take:]
            need -= take
        want = np.concatenate(head) if head else np.zeros(0, np.int64)
        check(np.array_equal(got_ids, _payload(want)),
              "dequeued elements are exactly the next ids in FIFO order")
        n_enq = int((v & e).sum())
        check(np.array_equal(pos[v & e], np.arange(self.n_enq,
                                                   self.n_enq + n_enq)),
              "enqueue positions are the next consecutive positions")
        check(np.array_equal(pos[dok], np.arange(self.n_deq,
                                                 self.n_deq + n_deq)),
              "dequeue positions are the next consecutive positions")
        check((pos[~m] == -1).all(), "⊥ and invalid ops carry position -1")
        self.n_enq += n_enq
        self.n_deq += n_deq
        self.size += n_enq - n_deq
        return {"enq": n_enq, "deq": n_deq, "bottom": int(bottom.sum())}


def phase_elastic(torch, rng, results):
    from repro_torch.dqueue import ElasticDeviceQueue
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import queue_scan
    N, CAP, W, L, K = 64, 65_536, 4, 1_024, 16

    def make(pipelined=True):
        return ElasticDeviceQueue(N, cap=CAP, payload_width=W,
                                  ops_per_shard=L, pipelined=pipelined,
                                  device="cuda")
    torch.cuda.reset_peak_memory_stats()
    eq = make()
    rt = eq.runtime
    model = FifoChecker()
    kept, bursts, migrations = [], [], []
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    queue_scan.launches = hash_route.launches = ring_commit.launches = 0

    def burst(p_enq):
        _run_burst(torch, rng, eq, rt, queue_scan, K, model, timing, bursts,
                      kept, (p_enq,), "queue-scan")
        check(eq.size == model.size, "queue size matches the FIFO model")

    while eq.size < 1_000_000:
        burst(0.65)
    backlog = eq.size
    _migrate(eq, rt, eq.shrink, list(range(48, 64)), migrations)  # LEAVE
    burst(0.5)
    _migrate(eq, rt, eq.grow, 16, migrations)                     # JOIN
    while eq.size > 0:
        burst(0.0)
    launches = queue_scan.launches
    check(launches > 0, "the main path launched the queue-scan kernel")
    commits = _commit_launches(ring_commit, timing["waves"], len(bursts))
    check(eq.size == 0 and model.pending == 0, "queue drained")
    peak = torch.cuda.max_memory_allocated()
    del eq
    _sequential_matches(torch, make, kept, K)
    rec = {"n_shards": N, "cap": CAP, "payload_width": W,
           "ops_per_shard": L, "K": K, "backlog_max": backlog,
           "bursts": len(bursts), "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "ops_per_s": timing["ops"] / timing["seconds"],
           "migrations": migrations, "queue_scan_launches": launches,
           "ring_commit_launches": commits,
           "max_memory_allocated": peak, "fifo_order": "ok",
           "sequential_equals_pipelined": True, "burst_log": bursts}
    results["elastic_fifo"] = rec
    emit("path:elastic_fifo", **rec)


def _take(blocks: deque, n: int) -> np.ndarray:
    """Pop the first ``n`` ids off a deque of id arrays."""
    head = []
    while n:
        blk = blocks[0]
        k = min(n, blk.size)
        head.append(blk[:k])
        if k == blk.size:
            blocks.popleft()
        else:
            blocks[0] = blk[k:]
        n -= k
    return np.concatenate(head) if head else np.zeros(0, np.int64)


class LifoChecker:
    """Host-side LIFO model in global op order: a push puts its id on top,
    a pop takes the top, or is ⊥ on an empty stack.  Vectorized: a push's
    position is the depth after it, a pop's the depth before it, and a pop
    returns the last id pushed at its position before it."""

    def __init__(self, max_depth: int):
        self.top = np.full(max_depth + 2, -1, np.int64)  # id per position
        self.depth = 0
        self.next_id = 0

    def stage(self, K: int, nL: int, p_push: float, rng, p_valid=0.9):
        """K waves, each all pushes or all pops (``round(p_push * K)`` push
        waves, shuffled), a ``p_valid`` share of each wave valid."""
        kinds = rng.permutation(K) < round(p_push * K)
        E = np.repeat(kinds[:, None], nL, 1)
        V = rng.random((K, nL)) < p_valid
        ids = np.arange(self.next_id, self.next_id + K * nL, dtype=np.int64)
        self.next_id += K * nL
        return E, V, _payload(ids).reshape(K, nL, 4)

    def verify(self, E, V, P, pos, m, dv, dok, ovf):
        e, v = E.reshape(-1), V.reshape(-1)
        push, pop = v & e, v & ~e
        step = np.where(push, 1, np.where(pop, -1, 0))
        walk = self.depth + np.cumsum(step)
        floor = np.maximum.accumulate(np.maximum(-walk, 0))
        prev = np.concatenate([[0], floor[:-1]])
        bottom = pop & (floor > prev)          # a pop on the empty stack
        after = walk + floor
        want_pos = np.where(push, after, np.where(pop & ~bottom, after + 1,
                                                  -1))
        m, dok, pos = m.reshape(-1), dok.reshape(-1), pos.reshape(-1)
        check(not ovf.any(), "no overflow")
        check(np.array_equal(pos, want_pos), "stack positions match the "
                                             "LIFO model")
        check(np.array_equal(m, v & ~bottom), "⊥ set matches the LIFO model")
        check(np.array_equal(dok, pop & ~bottom),
              "every matched pop found its element (none lost)")
        ids = P.reshape(-1, 4)[:, 0].astype(np.int64)
        idx = np.flatnonzero(push | (pop & ~bottom))
        order = np.lexsort((idx, want_pos[idx]))    # by position, then order
        sp, si = want_pos[idx][order], idx[order]
        is_push = push[si]
        j = np.arange(si.size)
        last_push = np.maximum.accumulate(np.where(is_push, j, -1))
        start = np.searchsorted(sp, sp)
        end = np.searchsorted(sp, sp, side="right") - 1
        from_burst = last_push >= start
        want_id = np.where(from_burst, ids[si[np.maximum(last_push, 0)]],
                           self.top[sp])
        exp = np.full(e.size, -1, np.int64)
        exp[si[~is_push]] = want_id[~is_push]
        got_pop = pop & ~bottom
        check((exp[got_pop] >= 0).all(), "every pop has a pushed element")
        check(np.array_equal(dv.reshape(-1, 4)[got_pop],
                             _payload(exp[got_pop])),
              "popped elements are exactly the LIFO model's, whole")
        keep = is_push & (last_push[end] == j)     # last push per position
        self.top[sp[keep]] = ids[si[keep]]
        self.depth = int(after[-1])
        return {"push": int(push.sum()), "pop": int(got_pop.sum()),
                "bottom": int(bottom.sum())}


def _max_pushes_per_position(p_push: float, n: int, rng) -> int:
    """Pushes to the most-pushed position in one randomly interleaved
    wave of ``n`` ops from a deep stack (each needs its own depth entry:
    the commit inserts a wave's pushes before its pops)."""
    e = rng.random(n) < p_push
    depth = 1_000_000 + np.cumsum(np.where(e, 1, -1))
    return int(np.unique(depth[e], return_counts=True)[1].max())


def _run_burst(torch, rng, es, rt, counter, K, checker, timing, bursts,
                  kept, stage_args, what):
    """Stage, run and check one pipelined burst on structure ``es``."""
    dev = es.device
    nL = es.n_shards * es.L
    staged = checker.stage(K, nL, *stage_args, rng)
    args = [torch.from_numpy(x).to(dev) for x in staged]
    x0, s0 = rt.n_exchanges, counter.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = es.run_waves(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(rt.n_exchanges - x0 == K + 1, "K+1 exchanges per burst")
    check(counter.launches - s0 == K, f"one {what} launch per wave")
    host = [o.cpu().numpy() for o in out]
    rec = checker.verify(*staged, *host)
    if len(kept) < 2:
        kept.append((staged, host))
    timing["waves"] += K
    timing["seconds"] += dt
    timing["ops"] += K * nL
    bursts.append({"n_shards": es.n_shards, "stage": list(stage_args),
                   "seconds": dt, **rec, "size": es.size})


def _migrate(es, rt, fn, arg, migrations):
    x0, size = rt.n_exchanges, es.size
    st = fn(arg)
    check(st["moved"] == size == es.size, "moved == size")
    check(rt.n_exchanges - x0 == 1, "one exchange per migration")
    migrations.append({k: st[k] for k in ("kind", "P_from", "P_to", "moved",
                                          "bytes_moved", "wave_s",
                                          "total_s")})


def _sequential_matches(torch, make, kept, K):
    """The first bursts again on a fresh structure with the sequential
    schedule: 2K exchanges each, outputs bit-identical."""
    seq = make(pipelined=False)
    dev = seq.device
    for staged, host in kept:
        x0 = seq.runtime.n_exchanges
        out = seq.run_waves(*(torch.from_numpy(x).to(dev) for x in staged))
        check(seq.runtime.n_exchanges - x0 == 2 * K,
              "2K exchanges per sequential burst")
        check(all(np.array_equal(o.cpu().numpy(), h)
                  for o, h in zip(out, host)),
              "pipelined and sequential bursts bit-identical")


def phase_elastic_lifo(torch, rng, results):
    from repro_torch.dqueue import ElasticDeviceStack, QueueOverflowError
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.segscan import stack_scan
    N, CAP, D, W, L, K = 64, 32_768, 4, 4, 1_024, 16
    dev = torch.device("cuda")

    def make(pipelined=True):
        return ElasticDeviceStack(N, cap=CAP, slot_depth=D, payload_width=W,
                                  ops_per_shard=L, pipelined=pipelined,
                                  device="cuda")
    torch.cuda.reset_peak_memory_stats()
    es = make()
    rt = es.runtime
    model = LifoChecker(max_depth=4_000_000)
    kept, bursts, migrations = [], [], []
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    stack_scan.launches = hash_route.launches = 0

    def burst(p_push):
        _run_burst(torch, rng, es, rt, stack_scan, K, model, timing, bursts,
                      kept, (p_push,), "stack-scan")
        check(es.size == model.depth, "stack size matches the LIFO model")

    while es.size < 1_000_000:
        burst(0.65)
    backlog = es.size
    check(backlog < 48 * CAP, "backlog fits the 48 shards after the LEAVE")
    _migrate(es, rt, es.shrink, list(range(48, 64)), migrations)  # LEAVE
    burst(0.5)
    _migrate(es, rt, es.grow, 16, migrations)                     # JOIN
    n_bottom = 0
    while es.size > 0 or n_bottom == 0:
        burst(0.0)
        n_bottom += bursts[-1]["bottom"]
    launches = stack_scan.launches
    check(launches > 0, "the main path launched the stack-scan kernel")
    peak = torch.cuda.max_memory_allocated()
    # the reference's commit inserts a wave's pushes before its pops, so a
    # position pushed j times in one wave needs j free depth entries: a
    # randomly interleaved wave overflows depth 4, and the path checks so
    e = rng.random(N * L) < 0.65
    v = np.ones(N * L, bool)
    raised = False
    try:
        es.step(torch.from_numpy(e).to(dev), torch.from_numpy(v).to(dev),
                torch.zeros(N * L, W, dtype=torch.int32, device=dev))
    except QueueOverflowError:
        raised = True
    check(raised, "an interleaved 65%-push wave overflows slot depth 4")
    del es
    _sequential_matches(torch, make, kept, K)
    rec = {"n_shards": N, "cap": CAP, "slot_depth": D, "payload_width": W,
           "ops_per_shard": L, "K": K, "traffic": "push waves and pop "
           "waves, 90% valid", "backlog_max": backlog,
           "bursts": len(bursts), "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "ops_per_s": timing["ops"] / timing["seconds"],
           "migrations": migrations, "stack_scan_launches": launches,
           "bottom_pops": n_bottom, "max_memory_allocated": peak,
           "lifo_order": "ok", "sequential_equals_pipelined": True,
           "interleaved_wave_overflows_depth_4": raised,
           "max_pushes_per_position_65pct_wave": _max_pushes_per_position(
               0.65, N * L, rng),
           "max_pushes_per_position_50pct_wave": _max_pushes_per_position(
               0.5, N * L, rng),
           "burst_log": bursts}
    results["elastic_lifo"] = rec
    emit("path:elastic_lifo", **rec)


class TierChecker:
    """Host-side P-tier model: per-tier FIFO deques.  A wave applies its
    enqueues first, then each dequeue in wave order takes the head of the
    most urgent non-empty tier; with relaxation k, the first tier in
    [best, best + k] whose head position is owned by the dequeue's shard
    (position mod n_shards) instead."""

    def __init__(self, P: int, tier_p, relaxation: int = 0, payload=None):
        self.P, self.tier_p, self.k = P, tier_p, relaxation
        self.payload = payload or _payload     # dequeued ids -> payload rows
        self.q = [deque() for _ in range(P)]
        self.heads, self.tails = [0] * P, [0] * P
        self.next_id = 0

    @property
    def sizes(self) -> list:
        return [t - h for h, t in zip(self.heads, self.tails)]

    def stage(self, K: int, nL: int, p_enq: float, rng):
        E = rng.random((K, nL)) < p_enq
        V = np.ones((K, nL), bool)
        PR = rng.choice(self.P, (K, nL), p=self.tier_p).astype(np.int32)
        ids = np.arange(self.next_id, self.next_id + K * nL, dtype=np.int64)
        self.next_id += K * nL
        return E, V, PR, _payload(ids).reshape(K, nL, 4)

    def _wave(self, e, v, pr, ids, n_shards):
        n = e.size
        enq, deq = v & e, v & ~e
        tier, pos = np.full(n, -1), np.full(n, -1)
        for t in range(self.P):
            mask = enq & (pr == t)
            c = int(mask.sum())
            tier[mask], pos[mask] = t, self.tails[t] + np.arange(c)
            self.q[t].append(ids[mask])
            self.tails[t] += c
        served = np.zeros(n, bool)
        vals, relaxed = [], 0
        d_idx = np.flatnonzero(deq)
        if self.k == 0:       # strict: the d-th dequeue takes the d-th best
            c = 0
            for t in range(self.P):
                take = min(self.sizes[t], d_idx.size - c)
                sel = d_idx[c:c + take]
                tier[sel], pos[sel] = t, self.heads[t] + np.arange(take)
                vals.append(_take(self.q[t], take))
                self.heads[t] += take
                c += take
            served[d_idx[:c]] = True
        else:
            # wave order, one dequeue at a time: p* only moves up within a
            # wave (sizes are fixed after the enqueues), the ids are taken
            # per tier afterwards in the same order
            L = n // n_shards
            sizes, heads = self.sizes, list(self.heads)
            best, served_tier = 0, []
            for i in d_idx:
                while best < self.P and sizes[best] == 0:
                    best += 1
                if best == self.P:
                    break
                q, s_i = best, i // L
                for c in range(best, min(best + self.k, self.P - 1) + 1):
                    if sizes[c] and heads[c] % n_shards == s_i:
                        q = c
                        break
                tier[i], pos[i] = q, heads[q]
                heads[q] += 1
                sizes[q] -= 1
                served[i] = True
                served_tier.append(q)
                relaxed += q != best
            served_tier = np.array(served_tier, np.int64)
            got = np.zeros(served_tier.size, np.int64)
            for t in range(self.P):
                sel = served_tier == t
                got[sel] = _take(self.q[t], int(sel.sum()))
            self.heads = heads
            vals.append(got)
        return tier, pos, enq | served, deq & served, vals, relaxed

    def verify(self, E, V, PR, P, tier, pos, m, dv, dok, ovf, nrel,
               n_shards=None):
        check(not ovf.any(), "no overflow")
        n_enq = n_deq = n_bottom = 0
        for k in range(E.shape[0]):
            ids = P[k, :, 0].astype(np.int64)
            w_tier, w_pos, w_m, w_ok, vals, rel = self._wave(
                E[k], V[k], PR[k], ids, n_shards)
            check(np.array_equal(tier[k], w_tier), "tiers match the model")
            check(np.array_equal(pos[k], w_pos), "positions match the model")
            check(np.array_equal(m[k], w_m), "⊥ set matches the model")
            check(np.array_equal(dok[k], w_ok),
                  "every matched dequeue found its element (none lost)")
            # vals are in serve order, which is wave order
            want = np.concatenate(vals) if vals else np.zeros(0, np.int64)
            check(np.array_equal(dv[k][w_ok], self.payload(want)),
                  "dequeued elements are exactly the model's, whole")
            check(int(nrel[k]) == rel, "relaxed serves match the model")
            n_enq += int((V[k] & E[k]).sum())
            n_deq += int(w_ok.sum())
            n_bottom += int((V[k] & ~E[k] & ~w_m).sum())
        return {"enq": n_enq, "deq": n_deq, "bottom": n_bottom,
                "relaxed": int(nrel.sum())}


def _commit_launches(ring_commit, waves: int, bursts: int) -> int:
    """The commit kernel's launches on a path of pipelined bursts, counted
    from 0 at its start: K + 1 a burst of K waves (the priming wave's
    commit and one a wave), so ``waves + bursts`` in all."""
    launches = ring_commit.launches
    check(launches == waves + bursts,
          f"one ring_commit launch a wave and one a burst ({launches} for "
          f"{waves} waves in {bursts} bursts)")
    return launches


def phase_elastic_priority(torch, rng, results):
    from repro_torch.dqueue import ElasticDevicePriorityQueue
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import tiered_queue_scan
    N, P_, CAP, W, L, K = 64, 4, 16_384, 4, 1_024, 16
    # most traffic in the urgent tiers, so the backlog spreads over the
    # lower ones and every tier fits 48 x 16,384 after the LEAVE
    TIER_P = [0.4, 0.3, 0.2, 0.1]

    def make(pipelined=True):
        return ElasticDevicePriorityQueue(N, n_prios=P_, cap=CAP,
                                          payload_width=W, ops_per_shard=L,
                                          pipelined=pipelined, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    eq = make()
    rt = eq.runtime
    model = TierChecker(P_, TIER_P)
    kept, bursts, migrations = [], [], []
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    tiered_queue_scan.launches = hash_route.launches = 0
    ring_commit.launches = 0

    def burst(p_enq):
        _run_burst(torch, rng, eq, rt, tiered_queue_scan, K, model, timing,
                      bursts, kept, (p_enq,), "tiered-scan")
        check(eq.sizes == model.sizes, "tier sizes match the model")

    while eq.size < 1_000_000:
        burst(0.65)
    backlog = eq.size
    sizes_at_leave = eq.sizes
    check(max(sizes_at_leave) <= 48 * CAP, "every tier fits 48 shards")
    _migrate(eq, rt, eq.shrink, list(range(48, 64)), migrations)  # LEAVE
    burst(0.5)
    _migrate(eq, rt, eq.grow, 16, migrations)                     # JOIN
    n_bottom = 0
    while eq.size > 0 or n_bottom == 0:
        burst(0.0)
        n_bottom += bursts[-1]["bottom"]
    launches = tiered_queue_scan.launches
    check(launches > 0, "the main path launched the tiered-scan kernel")
    commits = _commit_launches(ring_commit, timing["waves"], len(bursts))
    peak = torch.cuda.max_memory_allocated()
    del eq
    _sequential_matches(torch, make, kept, K)
    rec = {"n_shards": N, "n_prios": P_, "cap_per_tier": CAP,
           "payload_width": W, "ops_per_shard": L, "K": K,
           "tier_shares": TIER_P, "enqueue_share": 0.65,
           "backlog_max": backlog, "sizes_at_leave": sizes_at_leave,
           "bursts": len(bursts), "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "ops_per_s": timing["ops"] / timing["seconds"],
           "migrations": migrations, "tiered_scan_launches": launches,
           "ring_commit_launches": commits,
           "bottom_dequeues": n_bottom, "max_memory_allocated": peak,
           "priority_order": "ok", "sequential_equals_pipelined": True,
           "burst_log": bursts}
    results["elastic_priority"] = rec
    emit("path:elastic_priority", **rec)


def _hold_to_priority_oracle(oracle, staged, out, n_shards) -> None:
    """Each wave of a burst through the port's ``PriorityOracle``, op by
    op: tiers, positions, ⊥ flags, dequeued ids and relaxed serves must be
    the card's."""
    from repro_torch.core.priority import DEQ, ENQ
    E, V, PR, P = staged
    tier, pos, m, dv, dok, _ovf, nrel = out
    L = E.shape[1] // n_shards
    for k in range(E.shape[0]):
        ops = [None if not V[k, i] else
               (ENQ, int(PR[k, i]), int(P[k, i, 0]), i // L) if E[k, i]
               else (DEQ, 0, None, i // L) for i in range(E.shape[1])]
        recs = oracle.wave(ops, n_shards=n_shards)
        check(np.array_equal(tier[k], [r.tier for r in recs]) and
              np.array_equal(pos[k], [r.pos for r in recs]) and
              np.array_equal(m[k], [r.matched for r in recs]),
              "tiers, positions and ⊥ flags equal PriorityOracle's")
        got = [r.value is not None for r in recs]
        check(np.array_equal(dok[k], got) and np.array_equal(
            dv[k][dok[k], 0], [r.value for r in recs if r.value is not None]),
              "dequeued ids equal PriorityOracle's")
        check(int(nrel[k]) == sum(r.relaxed for r in recs),
              "relaxed serves equal PriorityOracle's")


def _hold_to_seap_oracle(oracle, staged, out) -> None:
    """Each wave of a burst through the port's ``SeapOracle``, op by op:
    buckets, positions, ⊥ flags, dequeued ids and the active bucket count
    must be the card's."""
    from repro_torch.core.seap import DEQ, ENQ
    E, V, KEY, P = staged
    bucket, pos, m, dv, dok, _ovf, nact = out
    for k in range(E.shape[0]):
        ops = [None if not V[k, i] else
               (ENQ, int(KEY[k, i]), int(P[k, i, 0])) if E[k, i]
               else (DEQ, 0, None) for i in range(E.shape[1])]
        recs = oracle.wave(ops)
        check(np.array_equal(bucket[k], [r.bucket for r in recs]) and
              np.array_equal(pos[k], [r.pos for r in recs]) and
              np.array_equal(m[k], [r.matched for r in recs]),
              "buckets, positions and ⊥ flags equal SeapOracle's")
        got = [r.value is not None for r in recs]
        check(np.array_equal(dok[k], got) and np.array_equal(
            dv[k][dok[k], 0], [r.value for r in recs if r.value is not None]),
              "dequeued ids equal SeapOracle's")
        check(int(nact[k]) == oracle.n_active,
              "active buckets equal SeapOracle's")


def phase_priority_many_tiers(torch, rng, results):
    """ElasticDevicePriorityQueue with 300 tiers, more than one tiered
    launch takes (two launches a wave, counted), on 4 shards: two bursts, a JOIN of 2, a
    burst, a LEAVE of 2 and a drain, on the card against the same staged
    waves on the CPU (bit for bit) and the host tier model."""
    from repro_torch.core.priority import PriorityOracle
    from repro_torch.dqueue import ElasticDevicePriorityQueue
    from repro_torch.kernels.segscan import tiered_queue_scan
    P_, N, CAP, W, L, K = 300, 4, 256, 4, 1_024, 4
    queues = {d: ElasticDevicePriorityQueue(
        N, n_prios=P_, cap=CAP, payload_width=W, ops_per_shard=L,
        pool_size=8, device=d) for d in ("cuda", "cpu")}
    card = queues["cuda"]
    model = TierChecker(P_, [1 / P_] * P_)
    oracle = PriorityOracle(P_)
    plan = [("burst", 0.7), ("burst", 0.7), ("grow", 2), ("burst", 0.5),
            ("shrink", [4, 5]), ("burst", 0.0), ("burst", 0.0)]
    bursts, migrations, waves, seconds, high = [], [], 0, 0.0, 0
    tiered_queue_scan.launches = 0
    for action, arg in plan:
        if action != "burst":
            moved = [(q.grow(arg) if action == "grow" else q.shrink(arg))
                     ["moved"] for q in queues.values()]
            check(moved[0] == moved[1] == card.size,
                  f"{action}: moved == size on the card and the CPU")
            migrations.append({"kind": action, "moved": moved[0],
                               "n_shards": card.n_shards})
            continue
        staged = model.stage(K, card.n_shards * L, arg, rng)
        outs = {}
        for d, q in queues.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = q.run_waves(*(torch.from_numpy(x).to(q.device)
                                for x in staged))
            outs[d] = [o.cpu().numpy() for o in out]
            if d == "cuda":
                seconds += time.perf_counter() - t0
        check(all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                       outs["cpu"])),
              "300 tiers: the card's burst bit-identical to the CPU's")
        bursts.append(model.verify(*staged, *outs["cuda"],
                                   n_shards=card.n_shards))
        _hold_to_priority_oracle(oracle, staged, outs["cuda"],
                                 card.n_shards)
        check(card.sizes == model.sizes == oracle.sizes,
              "tier sizes match the model and PriorityOracle")
        high += int((outs["cuda"][0] >= 256).sum())
        waves += K
    launches = tiered_queue_scan.launches
    check(launches == 2 * waves, f"two tiered launches a wave on the card "
                                 f"({launches} for {waves} waves)")
    check(high > 0, "ops placed in tiers past the first launch's 256")
    check(card.size == 0 and sum(b["bottom"] for b in bursts) > 0,
          "drained to ⊥")
    rec = {"n_prios": P_, "kernels_per_wave": launches / waves, "n_shards":
           "4 -> 6 -> 4", "cap_per_tier": CAP, "ops_per_shard": L, "K": K,
           "waves": waves, "ms_per_wave": seconds / waves * 1e3,
           "tiered_scan_launches": launches,
           "ops_in_tiers_past_255": high, "migrations": migrations,
           "card_equals_cpu": True, "priority_order": "ok",
           "priority_oracle": "equal",
           "bursts": bursts}
    results["priority_300_tiers"] = rec
    emit("path:priority_300_tiers", **rec)


def phase_relaxed_priority(torch, rng, results):
    """A small relaxed queue (8 shards x 64 ops, relaxation 1): the host
    resolution loop, and an 8 -> 6 migration whose hash-balance report
    goes through the hash-route kernel."""
    from repro_torch.core.priority import PriorityOracle
    from repro_torch.dqueue import ElasticDevicePriorityQueue
    from repro_torch.kernels.hash_route import hash_route
    dev = torch.device("cuda")
    K = 4
    eq = ElasticDevicePriorityQueue(8, n_prios=4, relaxation=1, cap=1_024,
                                    payload_width=4, ops_per_shard=64,
                                    pool_size=8, device="cuda")
    model = TierChecker(4, [0.1, 0.2, 0.3, 0.4], relaxation=1)
    oracle = PriorityOracle(4, relaxation=1)
    waves = seconds = 0.0
    logs = []

    def burst(p_enq):
        nonlocal waves, seconds
        staged = model.stage(K, eq.n_shards * eq.L, p_enq, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eq.run_waves(*(torch.from_numpy(x).to(dev) for x in staged))
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        waves += K
        host = [o.cpu().numpy() for o in out]
        logs.append(model.verify(*staged, *host, n_shards=eq.n_shards))
        _hold_to_priority_oracle(oracle, staged, host, eq.n_shards)
        check(eq.sizes == model.sizes == oracle.sizes,
              "tier sizes match the model and PriorityOracle")

    for p_enq in (0.7, 0.7, 0.5):
        burst(p_enq)
    hash_route.launches = 0
    size = eq.size
    st = eq.shrink([6, 7])
    check(st["moved"] == size == eq.size, "moved == size")
    check(hash_route.launches > 0,
          "the migration launched the hash-route kernel")
    burst(0.3)
    check(sum(r["relaxed"] for r in logs) > 0, "some serve was relaxed")
    rec = {"n_shards": "8->6", "ops_per_shard": 64, "relaxation": 1,
           "waves": waves, "ms_per_wave": seconds / waves * 1e3,
           "relaxed_serves": sum(r["relaxed"] for r in logs),
           "hash_balance": st["hash_balance"],
           "hash_route_launches": hash_route.launches,
           "priority_oracle": "equal", "bursts": logs}
    results["relaxed_priority"] = rec
    emit("path:relaxed_priority", **rec)


class SeapChecker:
    """Host-side Seap model, written from the semantics the reference
    states (``repro/core/seap.py``'s docstring) in numpy and plain ints:
    a key goes to the active bucket with the largest boundary ``lo <=
    key``; a wave applies its enqueues (FIFO per bucket), then its
    dequeues (the d-th takes the d-th element in boundary order), then
    the rebalance: when a bucket passes ``split_occupancy`` and no id is
    free, the lowest-id empty non-root bucket is dropped; then the
    fullest bucket past the threshold is halved into the lowest free id,
    at the floor midpoint of its range clamped to the observed key range
    (one step inside each edge), when that midpoint lies strictly inside
    the range.  ``payload`` maps dequeued ids to the payload rows."""

    def __init__(self, B: int, split_occupancy: int, seed_bounds=(),
                 payload=None):
        seeds = list(seed_bounds)
        self.B, self.occ = B, split_occupancy
        self.lo = [INT32_MIN] + seeds + [INT32_MAX] * (B - 1 - len(seeds))
        self.active = [True] * (1 + len(seeds)) + [False] * (
            B - 1 - len(seeds))
        self.heads, self.tails = [0] * B, [0] * B
        self.q = [deque() for _ in range(B)]
        self.key_lo, self.key_hi = INT32_MAX, INT32_MIN
        self.next_id = self.wave_no = 0
        self.splits = self.merges = 0
        self.payload = payload or _payload

    @property
    def sizes(self) -> list:
        return [t - h for h, t in zip(self.heads, self.tails)]

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @property
    def n_active(self) -> int:
        return sum(self.active)

    def directory(self) -> list:
        return sorted((self.lo[b], b) for b in range(self.B)
                      if self.active[b])

    def stage(self, K: int, nL: int, p_enq: float, slack, rng):
        """K waves of deadlines: wave number x 1,000 + slack drawn from
        U[slack)."""
        E = rng.random((K, nL)) < p_enq
        V = np.ones((K, nL), bool)
        wave = self.wave_no + np.arange(K)[:, None]
        KY = (wave * 1000 + rng.integers(*slack, (K, nL))).astype(np.int32)
        self.wave_no += K
        ids = np.arange(self.next_id, self.next_id + K * nL, dtype=np.int64)
        self.next_id += K * nL
        return E, V, KY, _payload(ids).reshape(K, nL, 4)

    def _rebalance(self):
        B, lo, act, sizes = self.B, self.lo, self.active, self.sizes
        over = [act[b] and sizes[b] > self.occ for b in range(B)]
        if any(over) and all(act):            # merge on demand
            for b in range(B):
                if act[b] and sizes[b] == 0 and lo[b] != INT32_MIN:
                    act[b] = False
                    self.merges += 1
                    break
        if any(over) and not all(act):        # split the fullest
            b_s = max(range(B), key=lambda b: (sizes[b] if over[b] else -1,
                                               -b))
            hi = min([lo[b] for b in range(B) if act[b] and lo[b] > lo[b_s]],
                     default=INT32_MAX)
            lo_eff = max(lo[b_s], self.key_lo - 1 if self.key_lo > INT32_MIN
                         else INT32_MIN)
            hi_eff = min(hi, self.key_hi + 1 if self.key_hi < INT32_MAX
                         else INT32_MAX)
            mid = (lo_eff + hi_eff) // 2
            if lo[b_s] < mid < hi:
                b_f = act.index(False)
                lo[b_f], act[b_f] = mid, True
                self.splits += 1

    def _wave(self, e, v, key, ids):
        n = e.size
        enq, deq = v & e, v & ~e
        bucket, pos = np.full(n, -1), np.full(n, -1)
        order = self.directory()
        los = np.array([lo for lo, _ in order], np.int64)
        bid = np.array([b for _, b in order])
        e_idx = np.flatnonzero(enq)
        ke = key[e_idx].astype(np.int64)
        be = bid[np.searchsorted(los, ke, side="right") - 1]
        bucket[e_idx] = be
        for b in range(self.B):
            idx = e_idx[be == b]
            pos[idx] = self.tails[b] + np.arange(idx.size)
            self.q[b].append(ids[idx])
            self.tails[b] += idx.size
        if e_idx.size:
            self.key_lo = min(self.key_lo, int(ke.min()))
            self.key_hi = max(self.key_hi, int(ke.max()))
        d_idx = np.flatnonzero(deq)
        vals, c = [], 0
        for _, b in order:                    # boundary order, FIFO inside
            take = min(self.tails[b] - self.heads[b], d_idx.size - c)
            sel = d_idx[c:c + take]
            bucket[sel], pos[sel] = b, self.heads[b] + np.arange(take)
            vals.append(_take(self.q[b], take))
            self.heads[b] += take
            c += take
        served = np.zeros(n, bool)
        served[d_idx[:c]] = True
        self._rebalance()
        return bucket, pos, enq | served, deq & served, vals, bid

    def verify(self, E, V, KY, P, bucket, pos, m, dv, dok, ovf, nact):
        check(not ovf.any(), "no overflow")
        n_enq = n_deq = n_bottom = 0
        for k in range(E.shape[0]):
            ids = P[k, :, 0].astype(np.int64)
            w_b, w_pos, w_m, w_ok, vals, order = self._wave(
                E[k], V[k], KY[k], ids)
            check(np.array_equal(bucket[k], w_b), "buckets match the model")
            check(np.array_equal(pos[k], w_pos), "positions match the model")
            check(np.array_equal(m[k], w_m), "⊥ set matches the model")
            check(np.array_equal(dok[k], w_ok),
                  "every matched dequeue found its element (none lost)")
            want = np.concatenate(vals) if vals else np.zeros(0, np.int64)
            check(np.array_equal(dv[k][w_ok], self.payload(want)),
                  "dequeued elements are exactly the model's, whole")
            check(int(nact[k]) == self.n_active,
                  "directory size matches the model")
            rank = np.argsort(order)[bucket[k][w_ok]]
            check(bool((np.diff(rank) >= 0).all()),
                  "a wave's dequeues come out in the directory's order")
            n_enq += int((V[k] & E[k]).sum())
            n_deq += int(w_ok.sum())
            n_bottom += int((V[k] & ~E[k] & ~w_m).sum())
        return {"enq": n_enq, "deq": n_deq, "bottom": n_bottom,
                "n_active": self.n_active, "splits": self.splits,
                "merges": self.merges}


# the EDF traffic of benchmarks/micro.py:_measure_edf_mixed at 1,000 key
# units a wave: deadlines = wave x 1,000 + slack, the slack drifting from
# the first half's range to the second's
SLACK_1, SLACK_2 = (2_000, 9_000), (13_000, 30_000)
# 64 fill waves reach phase_elastic_seap's backlog: their deadlines span
# [2,000, 72,000), and the seven seeds split that span into 8
SEAP_SEEDS = [2_000 + i * 70_000 // 8 for i in range(1, 8)]
SEAP_OCC = 64 * 16_384 // 4        # a quarter of a 64-shard bucket window


def phase_elastic_seap(torch, rng, results):
    """ElasticDeviceSeapQueue at full size: 64 shards x 8 buckets x 16,384
    slots per bucket x 4 words (a 134 MB store, 1,048,576 a bucket), a
    split threshold of a quarter of a bucket window and seven seed bounds
    over the first phase's deadlines.  Fill to above 1,000,000, drain the
    lowest buckets, drift the deadlines until an on-demand merge and a
    split show, LEAVE 16, one 50/50 burst, JOIN 16, drain to ⊥; every wave
    against the host Seap model."""
    from repro_torch.dqueue import ElasticDeviceSeapQueue
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import tiered_queue_scan
    N, B, CAP, W, L, K = 64, 8, 16_384, 4, 1_024, 16
    OCC, seeds = SEAP_OCC, SEAP_SEEDS

    def make(pipelined=True):
        return ElasticDeviceSeapQueue(N, n_buckets=B, cap=CAP,
                                      payload_width=W, ops_per_shard=L,
                                      split_occupancy=OCC, seed_bounds=seeds,
                                      pipelined=pipelined, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    eq = make()
    rt = eq.runtime
    model = SeapChecker(B, OCC, seeds)
    kept, bursts, migrations, dirs = [], [], [], []
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    tiered_queue_scan.launches = hash_route.launches = 0
    ring_commit.launches = 0

    def burst(p_enq, slack):
        _run_burst(torch, rng, eq, rt, tiered_queue_scan, K, model, timing,
                   bursts, kept, (p_enq, slack), "tiered-scan")
        check(eq.sizes == model.sizes, "bucket sizes match the model")
        check(eq.directory() == model.directory(),
              "the directory matches the model")
        dirs.append(eq.directory())

    while eq.size < 1_000_000:                       # 1. fill
        burst(0.65, SLACK_1)
    filled = eq.size
    while model.sizes[0] or model.sizes[1]:          # 2. drain the lowest
        burst(0.2, SLACK_1)
    while True:                                      # 3. drift
        burst(0.65, SLACK_2)
        if model.merges and model.splits:
            break
    backlog = eq.size
    sizes_at_leave = eq.sizes
    check(max(sizes_at_leave) <= 48 * CAP, "every bucket fits 48 shards")
    _migrate(eq, rt, eq.shrink, list(range(48, 64)), migrations)  # LEAVE
    check(eq.directory() == model.directory(), "the LEAVE kept the directory")
    burst(0.5, SLACK_2)
    _migrate(eq, rt, eq.grow, 16, migrations)                     # JOIN
    check(eq.directory() == model.directory(), "the JOIN kept the directory")
    n_bottom = 0
    while eq.size > 0 or n_bottom == 0:                           # drain
        burst(0.0, SLACK_2)
        n_bottom += bursts[-1]["bottom"]
    launches = tiered_queue_scan.launches
    check(launches == timing["waves"], "one tiered launch per wave")
    commits = _commit_launches(ring_commit, timing["waves"], len(bursts))
    enq = sum(b["enq"] for b in bursts)
    check(sum(b["deq"] for b in bursts) == enq and model.size == 0,
          "conservation: every enqueued element dequeued once")
    peak = torch.cuda.max_memory_allocated()
    del eq
    _sequential_matches(torch, make, kept, K)
    rec = {"n_shards": N, "n_buckets": B, "cap_per_bucket": CAP,
           "payload_width": W, "ops_per_shard": L, "K": K,
           "split_occupancy": OCC, "seed_bounds": seeds,
           "slack": [SLACK_1, SLACK_2], "filled": filled,
           "backlog_max": max(filled, backlog), "backlog_at_leave": backlog,
           "sizes_at_leave": sizes_at_leave, "bursts": len(bursts),
           "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "ops_per_s": timing["ops"] / timing["seconds"],
           "wall_s": timing["seconds"], "migrations": migrations,
           "tiered_scan_launches": launches,
           "ring_commit_launches": commits, "splits": model.splits,
           "merges": model.merges, "bottom_dequeues": n_bottom,
           "max_memory_allocated": peak, "edf_order": "ok",
           "sequential_equals_pipelined": True, "directories": dirs,
           "burst_log": bursts}
    results["elastic_seap"] = rec
    emit("path:elastic_seap", **rec)


def _edge_keys(shape, rng):
    """Keys over [-5,000, 5,000) with clusters at both int32 edges."""
    key = rng.integers(-5_000, 5_000, shape).astype(np.int64)
    edge = rng.random(shape)
    key[edge < 0.1] = INT32_MIN + rng.integers(0, 3, int((edge < 0.1).sum()))
    key[edge > 0.9] = INT32_MAX - rng.integers(0, 3, int((edge > 0.9).sum()))
    return key.astype(np.int32)


def phase_seap_card_vs_cpu(torch, rng, results):
    """A cold ElasticDeviceSeapQueue (8 buckets, 8 -> 6 -> 8 shards x
    1,024 ops, keys with clusters at INT32_MIN and INT32_MAX) on the card
    and on the CPU: every burst, the migrations (the hash-route report
    included) and the final state bit for bit, and the host model."""
    from repro_torch.core.seap import SeapOracle
    from repro_torch.dqueue import ElasticDeviceSeapQueue
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.segscan import tiered_queue_scan
    B, CAP, L, K, OCC = 8, 8_192, 1_024, 4, 6_000
    queues = {d: ElasticDeviceSeapQueue(
        8, n_buckets=B, cap=CAP, payload_width=4, ops_per_shard=L,
        split_occupancy=OCC, pool_size=8, device=d) for d in ("cuda", "cpu")}
    card = queues["cuda"]
    model = SeapChecker(B, OCC)
    oracle = SeapOracle(B, split_occupancy=OCC)
    plan = [("burst", 0.7), ("burst", 0.7), ("shrink", [6, 7]),
            ("burst", 0.5), ("grow", 2), ("burst", 0.3), ("burst", 0.0)]
    bursts, migrations, waves, seconds = [], [], 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    tiered_queue_scan.launches = hash_route.launches = 0
    for action, arg in plan:
        if action != "burst":
            st = [q.grow(arg) if action == "grow" else q.shrink(arg)
                  for q in queues.values()]
            check(st[0]["moved"] == st[1]["moved"] == card.size,
                  f"{action}: moved == size on the card and the CPU")
            check(st[0]["hash_balance"] == st[1]["hash_balance"],
                  f"{action}: the hash-route report equal on both")
            migrations.append({"kind": action, "moved": st[0]["moved"],
                               "hash_balance": st[0]["hash_balance"]})
            continue
        nL = card.n_shards * L
        E, V, _, P = model.stage(K, nL, arg, (0, 1), rng)
        staged = (E, V, _edge_keys((K, nL), rng), P)
        outs = {}
        for d, q in queues.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = q.run_waves(*(torch.from_numpy(x).to(q.device)
                                for x in staged))
            outs[d] = [o.cpu().numpy() for o in out]
            if d == "cuda":
                seconds += time.perf_counter() - t0
        check(all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                       outs["cpu"])),
              "Seap: the card's burst bit-identical to the CPU's")
        bursts.append(model.verify(*staged, *outs["cuda"]))
        _hold_to_seap_oracle(oracle, staged, outs["cuda"])
        check(card.directory() == model.directory() == oracle.directory(),
              "the directory matches the model and SeapOracle")
        waves += K
    state = [[x.cpu() for x in q.state] for q in queues.values()]
    junk = B * CAP
    state[0][6], state[1][6] = state[0][6][:, :junk], state[1][6][:, :junk]
    check(all(torch.equal(a, b) for a, b in zip(*state)),
          "the final 8-field state equal on the card and the CPU")
    check(tiered_queue_scan.launches == waves, "one tiered launch a wave")
    check(hash_route.launches == 2, "one hash-route launch a migration")
    check(model.splits > 0, "the directory split")
    rec = {"n_buckets": B, "n_shards": "8 -> 6 -> 8", "ops_per_shard": L,
           "K": K, "split_occupancy": OCC, "waves": waves,
           "wall_s": seconds, "waves_per_s": waves / seconds,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "tiered_scan_launches": tiered_queue_scan.launches,
           "hash_route_launches": hash_route.launches,
           "splits": model.splits, "merges": model.merges,
           "directory": model.directory(), "migrations": migrations,
           "card_equals_cpu": True, "seap_oracle": "equal",
           "bursts": bursts}
    results["seap_card_vs_cpu"] = rec
    emit("path:seap_card_vs_cpu", **rec)


# ------------------------------------------------- the paper's protocol --
# The port's Skueue at Fig. 4's ``--full`` setting (n = 1,024 processes,
# rate 1.0 per virtual node per round, 120 rounds, half enqueues), with
# churn: 16 processes JOIN at round 30 and 16 more at round 60, and 16
# processes (the anchor's among them) LEAVE at round 90.  Its total order
# ≺ (value(op), the paper's virtual counter) is then replayed on the card:
# the FIFO in waves of 64 x 1,024 ops; the stack's 70,000-odd global
# requests (the rest pair up locally) in waves of 64 x 256, so that the
# replay has a wave after each migration.  LEAVE 16 of 64 shards after the
# second wave, JOIN them back after the fourth.
PROTO_N, PROTO_RATE, PROTO_ROUNDS, PROTO_P_ENQ = 1_024, 1.0, 120, 0.5
PROTO_JOINS = {30: 16, 60: 16}          # round -> processes that JOIN
PROTO_LEAVE = (90, 16)                  # round, processes that LEAVE
PROTO_SHAPES = {"queue": {"cap": 65_536, "ops_per_shard": 1_024},
                "stack": {"cap": 32_768, "ops_per_shard": 256,
                          "slot_depth": 4}}
PROTO_PLAN = {2: ("shrink", list(range(48, 64))), 4: ("grow", 16)}


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def protocol_run(mode: str, seed: int, n: int = PROTO_N,
                 rounds: int = PROTO_ROUNDS, joins=PROTO_JOINS,
                 leave=PROTO_LEAVE, impl=None):
    """The port's ``Skueue`` (stack: with local combining) under random
    requests and the churn schedule, run until every request is done and
    every JOIN and LEAVE integrated, then checked: sequential consistency
    (the port's checker), DHT placement, membership.  Host code only.
    ``impl``, a ``(Skueue, check_sequential_consistency)`` pair, runs
    another implementation on the same schedule (a comparison passes the
    reference's; this script never imports it)."""
    from repro_torch.core.consistency import check_sequential_consistency
    from repro_torch.core.protocol import DEQ, ENQ, Skueue
    if impl is not None:
        Skueue, check_sequential_consistency = impl
    sk = Skueue(n, mode=mode, seed=seed)
    rng = np.random.default_rng(seed + 1)
    anchor_pid = sk.ring.proc[sk.ring.anchor]
    leavers = [anchor_pid] + [p for p in range(n)
                              if p != anchor_pid][:leave[1] - 1]

    def inject(s, rnd):
        for _ in range(joins.get(rnd, 0)):
            s.request_join()
        if rnd == leave[0]:
            for pid in leavers:
                s.request_leave(pid)
        nids = s.ring.node_ids()
        for _ in range(rng.binomial(len(nids), PROTO_RATE)):
            s.inject(nids[int(rng.integers(len(nids)))],
                     ENQ if rng.random() < PROTO_P_ENQ else DEQ)

    t0 = time.perf_counter()
    sk.run_rounds(rounds, inject_fn=inject)
    extra = 0
    while sk.pending_membership or sk.update_active:
        sk.run_rounds(1)
        extra += 1
        check(extra <= 10_000, "the membership changes complete")
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = check_sequential_consistency(sk)
    sk.check_dht_placement()
    check_s = time.perf_counter() - t0
    procs = {sk.ring.proc[v] for v in sk.ring.node_ids()}
    check(sk.pending_membership == 0, "pending_membership == 0")
    check(not procs & set(leavers), "no node runs on a process that left")
    check(len(procs) == n + sum(joins.values()) - len(leavers),
          "every JOIN and LEAVE took effect")
    lat = [r.t_done - r.t_issue for r in sk.requests]
    return sk, {
        "mode": mode, "n": n, "rate": PROTO_RATE, "rounds": rounds,
        "p_enq": PROTO_P_ENQ, "joins": joins, "leave": list(leave),
        "anchor_left": anchor_pid, "requests": stats["n_requests"],
        "global_requests": stats["n_requests"] - stats["n_locally_paired"],
        "locally_paired": stats["n_locally_paired"],
        "mean_rounds_per_request": float(np.mean(lat)),
        "total_msgs": sk.total_msgs, "update_phases": sk.update_phases,
        "max_batch_runs": sk.stats_batch_max_runs,
        "rounds_to_quiescence": sk.now, "processes": len(procs),
        "virtual_nodes": sk.ring.size, "consistent": True,
        "dht_placement": "ok", "pending_membership": 0,
        "host_sim_s": sim_s, "host_check_s": check_s}


def replay_protocol(torch, sk, es, plan) -> dict:
    """Feed the protocol's total order ≺ (its global requests by
    value(op); locally paired stack requests never reach the anchor) to
    the elastic structure ``es`` one wave of ``es.n_shards * es.L`` ops at
    a time, the element's id (``rid``) in payload word 0, migrating after
    the waves ``plan`` names.  Every op's position and ⊥ flag and every
    dequeued element must be the protocol's; no wave may overflow."""
    from repro_torch.core.intervals import BOTTOM
    reqs = sorted((r for r in sk.requests if r.order != -1),
                  key=lambda r: r.order)
    enq = np.array([r.kind == "enq" for r in reqs])
    elem = np.array([r.elem if r.kind == "enq" else 0 for r in reqs],
                    np.int64)
    want_pos = np.array([BOTTOM if r.pos is None else r.pos for r in reqs],
                        np.int64)
    want_res = np.array([r.result if r.kind == "deq" and r.result != BOTTOM
                         else 0 for r in reqs], np.int64)
    dev, rt = es.device, es.runtime
    waves, start, seconds, migrations, n_bottom = 0, 0, 0.0, [], 0
    while start < len(reqs):
        n = es.n_shards * es.L
        m = min(n, len(reqs) - start)
        sl = slice(start, start + m)
        E, V = np.zeros(n, bool), np.zeros(n, bool)
        E[:m], V[:m] = enq[sl], True
        P = np.zeros((n, es.W), np.int32)
        P[:m] = _payload(elem[sl])
        args = [torch.from_numpy(x).to(dev) for x in (E, V, P)]
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = es.step(*args)
        _sync(torch, dev)
        seconds += time.perf_counter() - t0
        pos, mt, dv, dok, ovf = (x.cpu().numpy() for x in out)
        matched = want_pos[sl] != BOTTOM
        deq_ok = ~enq[sl] & matched
        check(not ovf.any(), "no wave overflows")
        check(np.array_equal(pos[:m], want_pos[sl]),
              "positions equal the protocol's")
        check(np.array_equal(mt[:m], matched) and not mt[m:].any(),
              "⊥ flags equal the protocol's")
        check(np.array_equal(dok[:m], deq_ok),
              "every matched dequeue found its element")
        check(np.array_equal(dv[:m][deq_ok], _payload(want_res[sl][deq_ok])),
              "dequeued elements equal the protocol's, whole")
        n_bottom += int((~enq[sl] & ~matched).sum())
        waves += 1
        start += m
        if waves in plan:
            kind, arg = plan[waves]
            _migrate(es, rt, es.shrink if kind == "shrink" else es.grow, arg,
                     migrations)
            hb = es.migrations[-1].get("hash_balance")
            migrations[-1]["hash_balance"] = hb
            check(hb is None or sum(hb["counts"]) == es.size,
                  "the hash-route report covers every live position")
    want_size = sk.queue_size()
    check(es.size == want_size, "the size equals the protocol anchor's")
    return {"waves": waves, "ops": len(reqs), "bottom": n_bottom,
            "ops_per_wave_64_shards": 64 * es.L, "final_size": es.size,
            "replay_wall_ms": seconds * 1e3,
            "waves_per_s": waves / seconds, "migrations": migrations,
            "positions_bottoms_elements_equal": True, "overflow": False}


def phase_protocol_replay(torch, seed, results):
    """The paper's protocol in queue and stack mode (host), then its order
    replayed through the elastic FIFO queue and stack on the card."""
    from repro_torch.dqueue import ElasticDeviceQueue, ElasticDeviceStack
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import queue_scan, stack_scan
    rec = {}
    for mode, cls, scan in (("queue", ElasticDeviceQueue, queue_scan),
                            ("stack", ElasticDeviceStack, stack_scan)):
        sk, proto = protocol_run(mode, seed)
        es = cls(64, payload_width=4, device="cuda", **PROTO_SHAPES[mode])
        queue_scan.launches = stack_scan.launches = hash_route.launches = 0
        ring_commit.launches = 0
        rep = replay_protocol(torch, sk, es, PROTO_PLAN)
        launches = {"queue_scan": queue_scan.launches,
                    "stack_scan": stack_scan.launches,
                    "hash_route": hash_route.launches,
                    "ring_commit": ring_commit.launches}
        check(launches[scan.__name__] == rep["waves"],
              f"one {scan.__name__} launch a wave")
        check(launches["ring_commit"] >= rep["waves"] if mode == "queue"
              else launches["ring_commit"] == 0,
              f"{mode}: every queue wave, and no stack wave, committed "
              f"through the ring_commit kernel: {launches}")
        check(launches["hash_route"] == sum(
            m["hash_balance"] is not None for m in rep["migrations"]),
              "one hash-route launch a reported migration")
        rec[mode] = {**proto, **rep, **PROTO_SHAPES[mode], "n_shards":
                     "64 -> 48 -> 64", "launches": launches}
        del es
    for kernel in ("queue_scan", "stack_scan", "hash_route"):
        check(sum(r["launches"][kernel] for r in rec.values()) > 0,
              f"the replay launched {kernel}")
    results["protocol_replay"] = rec
    emit("path:protocol_replay", **rec)


def phase_data_pipeline(torch, results):
    """``synthetic_tokens`` on the card against the CPU, bit for bit, at
    the zamba2-1.2b prefill's shape (4 x 4,097 tokens), and two workers'
    slices of ``GlobalOrderPipeline`` against one worker's batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import GlobalOrderPipeline, synthetic_tokens
    vocab = get_config("zamba2_1p2b").vocab
    B, T, step = 4, 4_096, 7
    idx = np.arange(step * B, step * B + B)
    card = synthetic_tokens(idx, T + 1, vocab)
    host = synthetic_tokens(idx, T + 1, vocab, device="cpu")
    check(card.is_cuda and tuple(card.shape) == (B, T + 1),
          "tokens on the card, of the prefill's shape")
    check(torch.equal(card.cpu(), host), "card tokens equal the CPU's")
    pipe = GlobalOrderPipeline(T, vocab, B)
    full = pipe.batch_at_step(step)
    halves = [pipe.batch_at_step(step, n_workers=2, worker=w)
              for w in (0, 1)]
    for k in ("tokens", "targets", "sample_indices"):
        check(torch.equal(torch.cat([h[k] for h in halves]), full[k]),
              f"two workers' {k} concatenate to one worker's")
    check(torch.equal(full["tokens"].cpu(), host[:, :-1]) and
          torch.equal(full["targets"].cpu(), host[:, 1:]),
          "the pipeline's batch is the step's tokens")
    ms = time_ms(lambda: synthetic_tokens(idx, T + 1, vocab), 20, torch)
    rec = {"shape": [B, T + 1], "vocab": vocab, "step": step,
           "card_equals_cpu": True, "workers_concatenate": True,
           "synthetic_tokens_ms": ms}
    results["data_pipeline"] = rec
    emit("path:data_pipeline", **rec)


def _profile_burst(torch, structure, staged, label: str) -> dict:
    """One pipelined burst (after a warm-up burst) under torch.profiler:
    device time by operation, and the device's busy share of the burst's
    wall time.  Reports "not measured" where the profiler sees no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    structure.run_waves(*staged[0])            # warm-up burst
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        structure.run_waves(*staged[1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels are the CUDA-side events; host-side operators carry their
    # kernels' time as self device time.  Spans are skipped on both sides:
    # a span also shows as one device-side range over everything inside,
    # and counting it would count the burst's kernels twice.
    evs = [ev for ev in prof.key_averages()
           if not ev.key.startswith(("wave:", "membership:"))]
    busy = sum(ev.self_device_time_total for ev in evs
               if ev.device_type == DeviceType.CUDA)
    check(busy <= wall_us, f"{label}: device busy {busy} us within the "
                           f"burst's wall time {wall_us} us (one stream, "
                           f"nothing counted twice)")
    ops = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in evs
                  if ev.device_type != DeviceType.CUDA
                  and ev.self_device_time_total > 0), reverse=True)
    return {"burst": label, "wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "busy_share": busy / wall_us if busy else "not measured",
            "top_ops": [{"op": k, "device_ms": dt / 1e3, "calls": c}
                        for dt, k, c in ops[:10]]}


def phase_profile(torch, rng, results):
    """One 16-wave burst of each structure at full size, profiled (the
    Seap burst's directory is the full-size path's seeds)."""
    from repro_torch.dqueue import (ElasticDevicePriorityQueue,
                                    ElasticDeviceQueue,
                                    ElasticDeviceSeapQueue,
                                    ElasticDeviceStack)
    dev = torch.device("cuda")
    nL = 64 * 1_024

    def on_card(arrays):
        return [torch.from_numpy(x).to(dev) for x in arrays]
    recs = {}
    eq = ElasticDeviceQueue(64, cap=65_536, payload_width=4,
                            ops_per_shard=1_024, device="cuda")
    fm = FifoChecker()
    recs["fifo"] = _profile_burst(
        torch, eq, [on_card(fm.stage(16, nL, 0.5, rng)) for _ in range(2)],
        "queue: K=16, 64 shards x 1024 ops, 50% enqueue")
    del eq
    es = ElasticDeviceStack(64, cap=32_768, slot_depth=4, payload_width=4,
                            ops_per_shard=1_024, device="cuda")
    lm = LifoChecker(max_depth=4_000_000)
    recs["lifo"] = _profile_burst(
        torch, es, [on_card(lm.stage(16, nL, p, rng)) for p in (0.65, 0.5)],
        "stack: K=16, 64 shards x 1024 ops, 8 push and 8 pop waves")
    del es
    pq = ElasticDevicePriorityQueue(64, n_prios=4, cap=16_384,
                                    payload_width=4, ops_per_shard=1_024,
                                    device="cuda")
    tm = TierChecker(4, [0.4, 0.3, 0.2, 0.1])
    recs["priority"] = _profile_burst(
        torch, pq, [on_card(tm.stage(16, nL, p, rng)) for p in (0.65, 0.5)],
        "priority: K=16, 64 shards x 1024 ops, 4 tiers, 50% enqueue")
    del pq
    rq = ElasticDevicePriorityQueue(64, n_prios=4, relaxation=1, cap=16_384,
                                    payload_width=4, ops_per_shard=1_024,
                                    device="cuda")
    rm = TierChecker(4, [0.4, 0.3, 0.2, 0.1], relaxation=1)
    recs["relaxed"] = _profile_burst(
        torch, rq, [on_card(rm.stage(16, nL, p, rng)) for p in (0.65, 0.5)],
        "relaxed priority: K=16, 64 shards x 1024 ops, 4 tiers, "
        "relaxation 1, 50% enqueue")
    del rq
    tq = ElasticDeviceQueue(64, cap=65_536, payload_width=4,
                            ops_per_shard=1_024, metrics=True, device="cuda")
    recs["fifo_telemetry"] = _profile_burst(
        torch, tq, [on_card(fm.stage(16, nL, 0.5, rng)) for _ in range(2)],
        "queue with the metrics ring: K=16, 64 shards x 1024 ops, 50% "
        "enqueue")
    del tq
    sq = ElasticDeviceSeapQueue(64, n_buckets=8, cap=16_384, payload_width=4,
                                ops_per_shard=1_024, split_occupancy=SEAP_OCC,
                                seed_bounds=SEAP_SEEDS, device="cuda")
    sm = SeapChecker(8, SEAP_OCC, SEAP_SEEDS)
    recs["seap"] = _profile_burst(
        torch, sq, [on_card(sm.stage(16, nL, p, SLACK_1, rng))
                    for p in (0.65, 0.5)],
        "seap: K=16, 64 shards x 1024 ops, 8 buckets, 50% enqueue, "
        "deadlines wave x 1,000 + U[2,000, 9,000)")
    del sq
    results["profile"] = recs
    emit("profile", **recs)


def phase_scan_device_split(torch, rng, results):
    """The device side of the four queue kernels' wrapper calls, at the
    sizes their wrappers were timed at: the kernels each call ran and
    their device ms, from the profiler's kernel durations; the FIFO, stack
    and tiered scans must run one kernel per call, the tiered scan at 512 tiers two.  It runs after the
    paths, with the other profiled phases: a profiler session slows the
    launches that follow it, so none comes before the paths are timed."""
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.segscan import (queue_scan, stack_scan,
                                             tiered_queue_scan)
    dev = torch.device("cuda")
    out = {}
    for n in TIMED_N:
        e = torch.from_numpy(rng.random(n) < 0.65).to(dev)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        tier = torch.from_numpy(rng.choice(4, n, p=[0.4, 0.3, 0.2, 0.1])
                                .astype(np.int32)).to(dev)
        tier512 = torch.from_numpy(rng.integers(0, 512, n).astype(
            np.int32)).to(dev)
        lasts = torch.full((4,), 200_000, dtype=torch.int32, device=dev)
        lasts512 = torch.zeros(512, dtype=torch.int32, device=dev)
        f_t = torch.tensor(0, dtype=torch.int32, device=dev)
        l_t = torch.tensor(-1, dtype=torch.int32, device=dev)
        a = torch.tensor(500_000, dtype=torch.int32, device=dev)
        b = torch.tensor(700_000, dtype=torch.int32, device=dev)
        calls = {"queue_scan": (lambda: queue_scan(e, v, f_t, l_t),
                                {"queue_scan_lookback": 1}),
                 "stack_scan": (lambda: stack_scan(e, v, a, b),
                                {"stack_scan_lookback": 1}),
                 "tiered_queue_scan": (
                     lambda: tiered_queue_scan(e, tier, lasts, lasts, 4),
                     {"tiered_scan_lookback": 1})}
        for name, (fn, expect) in calls.items():
            split = _device_split(torch, fn, f"{name} n={n}", expect)
            results[(name, n)].update(split)
            out[f"{name} n={n}"] = split
        # two groups: two launches, beside the re-base, merge and concat
        calls = _kernel_calls(torch, lambda: tiered_queue_scan(
            e, tier512, lasts512, lasts512, 512), reps=20)
        if calls:
            check(calls.get("tiered_scan_lookback", (0, 0))[0] == 2.0,
                  f"tiered_queue_scan n={n} P=512: two tiered launches per "
                  f"call, got {calls}")
            split = {"device_ms": sum(ms for _, ms in calls.values()),
                     "tiered_scan_lookback_ms": calls[
                         "tiered_scan_lookback"][1],
                     "device_kernels": {k: c for k, (c, _) in calls.items()}}
        else:
            split = {"device_ms": "not measured",
                     "device_kernels": "not measured"}
        results[("tiered_queue_scan", n)]["device_ms_512_tiers"] = split[
            "device_ms"]
        out[f"tiered_queue_scan n={n} P=512"] = split
    from repro_torch.kernels.relaxed import relaxed_deletemin
    for name in ("p4_k1", "p4_k2", "p300_k2"):
        r = results[("relaxed_deletemin", name)]
        args = [torch.from_numpy(x).to(dev) for x in _relaxed_case(
            rng, r["n"], r["n_prios"], r["n_shards"], "mixed")]
        split = _device_split(
            torch, lambda: relaxed_deletemin(*args, r["n_prios"],
                                             r["relaxation"], r["n_shards"]),
            f"relaxed_deletemin {name}", {"relaxed_deletemin": 1})
        r.update(split)
        out[f"relaxed_deletemin {name}"] = split
    for n_shards in (48, 64):
        r = results[("hash_route", 16_777_216, n_shards)]
        pos = torch.from_numpy(((r["base"] + np.arange(r["n"], dtype=np.int64)
                                 + 2 ** 31) % 2 ** 32 - 2 ** 31)
                               .astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.random(r["n"]) < 0.9).to(dev)
        split = _device_split(torch, lambda: hash_route(pos, valid, n_shards),
                              "hash_route", {"hash_route": 1})
        r.update(split)
        out[f"hash_route n={r['n']} n_shards={n_shards}"] = split
    from repro_torch.kernels.ring_commit import ring_commit
    for n_sh in RING_SHARDS:
        (sv, sf), view, junk = _ring_wave(torch, rng, n_sh)
        launches0 = ring_commit.launches
        split = _device_split(
            torch, lambda: ring_commit((sv, sf), view, junk, sv.shape[-1]),
            f"ring_commit {n_sh} shards", {"ring_commit": 1})
        results[("ring_commit", n_sh)].update(
            split, profiled_launches=ring_commit.launches - launches0)
        out[f"ring_commit {n_sh} shards"] = split
    floor = results["hash_route_floor"]
    for n in HASH_FLOOR_N:
        p = torch.arange(n, dtype=torch.int32, device=dev)
        va = torch.ones(n, dtype=torch.bool, device=dev)
        floor[n].update(_device_split(torch, lambda: hash_route(p, va, 64),
                                      f"hash_route n={n}",
                                      {"hash_route": 1}))
    emit("kernel:device_split", **out)
    emit("kernel:hash_route_floor", n_shards=64, by_n=floor)


def phase_hash_balance(torch, rng, results):
    from repro_torch.dqueue import ElasticDeviceQueue
    from repro_torch.kernels.hash_route import hash_route, hash_route_ref
    from repro_torch.kernels.segscan import queue_scan
    dev = torch.device("cuda")
    eq = ElasticDeviceQueue(8, cap=16_384, payload_width=4,
                            ops_per_shard=1_024, device="cuda")
    model = FifoChecker()
    E, V, P = model.stage(16, 8 * 1_024, 0.65, rng)
    host = [o.cpu().numpy() for o in
            eq.run_waves(*(torch.from_numpy(x).to(dev) for x in (E, V, P)))]
    model.verify(E, V, P, *host)
    lo, hi = int(eq.state.first), int(eq.state.last)
    check(0 < hi - lo + 1 <= 65_536, "live set small enough for the report")
    queue_scan.launches = hash_route.launches = 0
    st = eq.shrink([6, 7])
    launches = hash_route.launches
    check(launches > 0, "the migration launched the hash-route kernel")
    check(st["moved"] == eq.size, "moved == size")
    pos = torch.arange(lo, hi + 1, dtype=torch.int32)
    _, want = hash_route_ref(pos, torch.ones(pos.shape[0], dtype=torch.bool),
                             6)
    hb = st["hash_balance"]
    check(hb["counts"] == want.tolist(),
          "hash_balance counts equal the plain version's")
    # the kernel against its plain version at the path's own shape, both
    # outputs (owner and counts) on the same device tensors
    n = hi - lo + 1
    pos_d = pos.to(dev)
    valid_d = torch.ones(n, dtype=torch.bool, device=dev)
    got = hash_route(pos_d, valid_d, 6)
    want = hash_route_ref(pos_d, valid_d, 6)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(got, want))
    check(identical, f"hash_route n={n} n_shards=6 owner and counts "
                     f"identical to the plain version")
    err = max_abs_err(got, want)
    ms = time_ms(lambda: hash_route(pos_d, valid_d, 6), 100, torch)
    plain = time_ms(lambda: hash_route_ref(pos_d, valid_d, 6), 20, torch)
    dev_split = _device_split(torch, lambda: hash_route(pos_d, valid_d, 6),
                              "hash_route", {"hash_route": 1})
    b_ms, b_by = bound(9 * n + 24, HASH_OPS * n)
    rec = {"n_shards": "8->6", "n": n, "hash_balance": hb,
           "hash_route_launches": launches, "identical": identical,
           "ms": ms, **dev_split, "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by, "max_abs_err": err}
    results["hash_balance"] = rec
    emit("path:hash_balance", **rec)


# ------------------------------------------------------------ model zoo --
def _visible_pairs(Lq: int, Lk: int, window, causal: bool = True) -> int:
    """(query, key) pairs a causal (and windowed) mask keeps, queries
    aligned to the end of the keys: the work this input needs (every
    pair where nothing is masked)."""
    if not causal and window is None:
        return Lq * Lk
    qp = np.arange(Lq, dtype=np.int64) + (Lk - Lq)
    lo = np.zeros(Lq, np.int64) if window is None else np.maximum(
        qp - window + 1, 0)
    return int(np.clip(np.minimum(qp, Lk - 1) - lo + 1, 0, None).sum())


def _family_flash_cases(torch, bwd: bool = False) -> list:
    """The flash-attention shapes of the moe, vlm and encdec paths, as
    (case, B, Hq, Hkv, Lq, Lk, D, causal, window, dtype, timing reps):
    whisper-small's encoder (not causal, 1,500 frames: no tile multiple),
    its cross-attention (448 text positions against 1,500 frames), the
    train_4k split's 4,096 tokens against 1,500 frames (Lq > Lk, not
    causal), granite-moe-1b's 16 query heads over 8 (G 2, D 64) and,
    forward only (nothing trains it here), llava-next-34b's 56 over 8
    (G 7, D 128)."""
    bf16 = torch.bfloat16
    cases = [
        ("encoder: whisper-small, not causal, 1,500 frames", 8, 12, 12,
         1500, 1500, 64, False, None, bf16, 10),
        ("cross: whisper-small, 448 x 1,500, not causal", 8, 12, 12, 448,
         1500, 64, False, None, bf16, 10),
        ("Lq > Lk: 4,096 x 1,500, not causal", 2, 12, 12, 4096, 1500, 64,
         False, None, bf16, 10),
        ("gqa G 2: granite-moe-1b heads", 4, 16, 8, 4096, 4096, 64, True,
         None, bf16, 10)]
    if not bwd:
        cases.append(("gqa G 7, D 128: llava-next-34b heads", 2, 56, 8,
                      4096, 4096, 128, True, None, bf16, 5))
    return cases


def _flash_err(torch, got, want) -> dict:
    """The error of ``got`` against ``want`` as the check reads it: the
    largest |got - want|, the largest share of the per-element limit
    (bf16: FLASH_RTOL |want| + FLASH_ATOL; f32: FLASH_F32_TOL) it uses,
    and in bf16 the largest part of |got - want| beyond one bf16 step."""
    d, w = (got.float() - want.float()).abs(), want.float().abs()
    err = {"max_abs_err": float(d.max()), "median_abs_want": float(
        w.median())}
    if got.dtype == torch.float32:
        err["share_of_limit"] = float(d.max() / FLASH_F32_TOL)
    else:
        err["share_of_limit"] = float((d / (FLASH_RTOL * w + FLASH_ATOL))
                                      .max())
        err["beyond_one_step"] = float((d - FLASH_RTOL * w).clamp(min=0)
                                       .max())
    return err


def phase_flash_attention(torch, results):
    """The flash-attention kernel against its plain version (query-chunked
    attention) on the same device tensors, in the model's [B, L, H, D]
    layout; SDPA on the causal inputs as the yardstick."""
    from repro_torch.kernels.flash_attention import (attention_chunked,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import tc_route
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    # (case, B, Hq, Hkv, Lq, Lk, D, causal, window, dtype, timing reps);
    # the first is the prefill path's call, which the kernels line reports
    cases = [("prefill_path: zamba2 shared block", 4, 32, 32, 4096, 4096,
              64, True, None, bf16, 10),
             ("prefill_32k", 1, 32, 32, 32_768, 32_768, 64, True, None,
              bf16, 2),
             ("gqa: llama3-8b heads", 1, 32, 8, 4096, 4096, 128, True, None,
              bf16, 10),
             ("sliding window 1024", 2, 32, 32, 4096, 4096, 64, True, 1024,
              bf16, 10),
             ("ragged: Lq < Lk, no multiple of 64", 2, 8, 2, 1000, 1500,
              128, True, None, bf16, 10),
             ("prefill_path in f32", 4, 32, 32, 4096, 4096, 64, True, None,
              f32, 3)] + _family_flash_cases(torch)
    launches0 = flash_attention.launches
    for case, B, Hq, Hkv, Lq, Lk, D, causal, window, dt, reps in cases:
        q = torch.randn(B, Lq, Hq, D, generator=gen, device=dev,
                        dtype=dt).transpose(1, 2)
        k, v = (torch.randn(B, Lk, Hkv, D, generator=gen, device=dev,
                            dtype=dt).transpose(1, 2) for _ in range(2))
        tc0 = flash_attention.tc_launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = attention_chunked(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tc = flash_attention.tc_launches - tc0
        check(tc == int(tc_route(dt, D, Lq)),
              f"flash_attention {case}: the launcher reports the route "
              f"rule's kernel")
        # the kernel the device ran, by name, from the profiler's trace
        ran = _by_kernel(torch, lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        if ran != "not measured":
            check(set(ran) == {"flash_fwd_wgmma" if tc else "flash_fwd"},
                  f"flash_attention {case}: the device ran {sorted(ran)}")
        err = _flash_err(torch, got, want)
        check(got.shape == (B, Hq, Lq, D) and got.dtype == dt,
              f"flash_attention {case}: shape and type")
        check(err["share_of_limit"] <= 1.0,
              f"flash_attention {case}: every element within its limit of "
              f"the plain one: {err}")
        del got, want
        w = 1 if reps < 10 else 3
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                             window=window), reps, torch, w)
        plain = time_ms(lambda: attention_chunked(q, k, v, causal=causal,
                                                  window=window),
                        max(1, reps // 5), torch, 1)
        lib = None
        # SDPA aligns a causal mask to the start of the keys: the same
        # function where Lq == Lk, or where nothing is masked
        if window is None and (Lq == Lk or not causal):
            lib = time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                       enable_gqa=Hq != Hkv),
                          reps, torch, w)
        pairs = B * Hq * _visible_pairs(Lq, Lk, window, causal)
        size = q.element_size()
        n_bytes = size * D * (2 * B * Hq * Lq + 2 * B * Hkv * Lk)
        peak = BF16_FLOPS if dt == bf16 else F32_FLOPS
        b_ms, b_by = bound(n_bytes, 4 * D * pairs, peak)
        rec = {"case": case, "B": B, "Hq": Hq, "Hkv": Hkv, "Lq": Lq,
               "Lk": Lk, "D": D, "window": window,
               "kernel": "flash_fwd_wgmma (tensor cores: wgmma, TMA)" if tc
               else "flash_fwd (scalar f32)",
               "device_kernels": sorted(ran) if isinstance(ran, dict)
               else ran,
               "device_ms": sum(ran.values()) if isinstance(ran, dict)
               else ran,
               "dtype": str(dt).split(".")[-1], "causal": causal, **err,
               "tolerance": (f"|d| <= {FLASH_RTOL} |want| + {FLASH_ATOL}"
                             if dt == bf16 else f"|d| <= {FLASH_F32_TOL}"),
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "library": "torch.nn.functional.scaled_dot_product_attention"
               if lib is not None else "none: masked alignment differs",
               "flops": 4 * D * pairs, "bytes": n_bytes, "bound_ms": b_ms,
               "bound_by": b_by, "peak": ("989 TFLOP/s bf16" if dt == bf16
                                          else "67 TFLOP/s f32")
               + ", 3.35 TB/s"}
        results.setdefault("flash_attention", []).append(rec)
        emit("kernel:flash_attention", **rec)
        del q, k, v
    results["flash_attention_check_launches"] = (flash_attention.launches
                                                 - launches0)


def phase_ssd_scan(torch, results):
    """The SSD-scan kernel against its plain version (the chunked form) on
    the same device tensors, in the model's form: xt/loga views of
    [b, L, H, ...] buffers, B/C a stride-0 expand of [b, L, N] bf16."""
    from repro_torch.kernels.ssd_scan import ssd_chunked_ref, ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import CHUNK
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    # (case, b, H, L, P, N, timing reps)
    cases = [("prefill_path: zamba2 mamba layer", 4, 64, 4096, 64, 64, 10),
             ("prefill_32k", 1, 64, 32_768, 64, 64, 3),
             ("mamba2-130m state 128", 4, 24, 4096, 64, 128, 10),
             ("ragged: L = 1000", 2, 64, 1000, 64, 64, 10)]
    for case, b, H, L, P, N, reps in cases:
        dt = torch.nn.functional.softplus(torch.randn(
            b, L, H, generator=gen, device=dev))
        xt = (torch.randn(b, L, H, P, generator=gen, device=dev)
              * dt[..., None]).transpose(1, 2)
        loga = (-dt).transpose(1, 2)
        Bm, Cm = ((torch.randn(b, L, N, generator=gen, device=dev) * 0.3)
                  .to(torch.bfloat16) for _ in range(2))
        Bh, Ch = (m[:, None].expand(b, H, L, N) for m in (Bm, Cm))
        got = ssd_scan(xt, loga, Bh, Ch)
        want = ssd_chunked_ref(xt, loga, Bh, Ch)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        check(got.shape == (b, H, L, P), f"ssd_scan {case}: shape")
        check(rel <= SSD_REL_TOL, f"ssd_scan {case}: error {rel} of max |y| "
                                  f"within {SSD_REL_TOL}")
        del got, want
        ms = time_ms(lambda: ssd_scan(xt, loga, Bh, Ch), reps, torch)
        plain = time_ms(lambda: ssd_chunked_ref(xt, loga, Bh, Ch),
                        max(1, reps // 5), torch, 1)
        n_bytes = 4 * 2 * b * H * L * P + 4 * b * H * L + 2 * 2 * b * L * N
        flops = 4 * b * H * L * N * P        # the per-token recurrence
        b_ms, b_by = bound(n_bytes, flops, F32_3XTF32_FLOPS)
        rec = {"case": case, "b": b, "H": H, "L": L, "P": P, "N": N,
               "xt": "float32", "B/C": "bfloat16, stride 0 over heads",
               "kernel": "chunk-parallel: ssd_scan_states, ssd_scan_pass, "
                         "ssd_scan_outputs (mma.sync: bf16 C·Bᵀ, 3xTF32)",
               "chunk": CHUNK, "launches_per_call": 3,
               "by_pass_ms": _by_kernel(torch, lambda: ssd_scan(
                   xt, loga, Bh, Ch)),
               "max_abs_err": err, "rel_err": rel,
               "tolerance_rel": SSD_REL_TOL, "ms": ms, "plain_ms": plain,
               "library_ms": None,
               "library": "none: no single PyTorch call computes the scan",
               "flops": flops, "bytes": n_bytes, "bound_ms": b_ms,
               "bound_by": b_by,
               "peak": "165 TFLOP/s f32 as 3xTF32, 3.35 TB/s"}
        results.setdefault("ssd_scan", []).append(rec)
        emit("kernel:ssd_scan", **rec)
        del xt, loga, Bm, Cm, Bh, Ch, dt


def _kernel_calls(torch, fn, reps: int = 3, tries: int = 5) -> dict:
    """{kernel name: (launches per call, device ms per call)} of each
    kernel that ``fn`` launches, from torch.profiler's kernel events
    (after one warm-up call); {} where the profiler sees no device time.
    The profiler on the card's machine loses kernel events now and then:
    most often a session's first kernel, so each session starts with a
    lead-in kernel (``spin_kernel``, left out of the result); late in a
    long run, a session's last call (all its kernels, in five sessions
    in a row), so each session ends with a ~10 ms spin kernel too; at
    times others, so a session whose launches per call are not whole
    numbers (or that saw none) runs again, up to ``tries`` sessions, and
    the one that saw the most kernels is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            if (ev.device_type == DeviceType.CUDA
                    and ev.self_device_time_total
                    and "spin_kernel" not in ev.key):
                m = re.search(r"::(\w+)", ev.key)
                name = m.group(1) if m else ev.key[:60]
                c, ms = out.get(name, (0, 0.0))
                out[name] = (c + ev.count,
                             ms + ev.self_device_time_total / reps / 1e3)
        if sum(c for c, _ in out.values()) > sum(c for c, _ in best.values()):
            best = out
        if out and all(c % reps == 0 for c, _ in out.values()):
            break
    return {k: (c / reps, ms) for k, (c, ms) in best.items()}


def _by_kernel(torch, fn, reps: int = 3) -> dict:
    """Mean device ms per call of each kernel that ``fn`` launches, from
    torch.profiler (after one warm-up call); "not measured" where the
    profiler sees no device time."""
    calls = _kernel_calls(torch, fn, reps)
    return {k: ms for k, (_, ms) in calls.items()} or "not measured"


def _device_split(torch, fn, what: str, expect=None) -> dict:
    """The device side of one wrapper call, from the profiler's kernel
    durations: the kernels it ran and their summed device ms, to set
    beside the wrapper's CUDA-event ms (which at one wave is the host's
    issue time).  With ``expect`` ({kernel name: launches per call}),
    checks that the call ran exactly those kernels, that many times."""
    calls = _kernel_calls(torch, fn, reps=20)
    if not calls:
        return {"device_ms": "not measured", "device_kernels": "not measured"}
    per_call = {k: c for k, (c, _) in calls.items()}
    if expect is not None:
        check(per_call == {k: float(c) for k, c in expect.items()},
              f"{what}: one call ran {per_call} (launches per call by "
              f"kernel name), expected {expect}")
    return {"device_ms": sum(ms for _, ms in calls.values()),
            "device_kernels": per_call}


def _zamba2(torch, seed):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("zamba2_1p2b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda")
    return cfg, model, params, gen


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return tree.numel()


def _profile_prefill(torch, fn) -> dict:
    """One prefill (``fn()``) under torch.profiler: device time by kind of
    kernel and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = prof.key_averages()
    busy = sum(ev.self_device_time_total for ev in evs
               if ev.device_type == DeviceType.CUDA)
    kernels = sorted(((ev.self_device_time_total, ev.key, ev.count)
                      for ev in evs if ev.device_type == DeviceType.CUDA
                      and ev.self_device_time_total > 0), reverse=True)
    by_kind = {"ssd_scan": 0.0, "flash_attention": 0.0, "cuBLAS products":
               0.0, "gathers and scatters (embedding, MoE dispatch, "
               "combine)": 0.0, "other (elementwise, copies, norms)": 0.0}
    flash_calls = {"flash_fwd_wgmma": 0, "flash_fwd": 0}
    for t, k, c in kernels:
        kind = ("ssd_scan" if "ssd_scan" in k else
                "flash_attention" if "flash_fwd" in k else
                "cuBLAS products" if any(w in k.lower() for w in (
                    "nvjet", "gemm", "xmma", "cutlass")) else
                "gathers and scatters (embedding, MoE dispatch, combine)"
                if "index" in k.lower() else
                "other (elementwise, copies, norms)")
        by_kind[kind] += t / 1e3
        if kind == "flash_attention":
            flash_calls["flash_fwd_wgmma" if "flash_fwd_wgmma" in k
                        else "flash_fwd"] += c
    return {"wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "busy_share": busy / wall_us if busy else "not measured",
            "device_ms_by_kind": by_kind,
            "flash_kernel_calls": flash_calls if busy else "not measured",
            "top_kernels": [{"kernel": k[:120], "device_ms": t / 1e3,
                             "calls": c} for t, k, c in kernels[:12]]}


def _card_vs_cpu(torch, seed) -> dict:
    """The bf16 prefill of zamba2-1.2b at full width and cut depth on the
    card against the same prefill on the CPU, each beside the CPU's f32
    prefill of the same weights (see CARD_CPU_TOL); weights from seed + 1."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import build_model
    cfg = replace(get_config("zamba2_1p2b"), n_layers=CARD_CPU_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = model.init_params(gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, CARD_CPU_TOKENS), generator=gen,
                           device="cuda")
    tc0, s0 = flash_attention.tc_launches, ssd_scan.launches
    card = model.prefill(params, tokens).cpu()
    n_attn = cfg.n_layers // cfg.attn_every
    check(flash_attention.tc_launches - tc0 == n_attn
          and ssd_scan.launches - s0 == cfg.n_layers,
          f"card vs CPU: the card's prefill took the tensor-core flash "
          f"route {n_attn} times and the SSD kernel {cfg.n_layers} times")
    cpu_params, cpu_tokens = _to(params, "cpu"), tokens.cpu()
    t0 = time.perf_counter()
    cpu = model.prefill(cpu_params, cpu_tokens)
    cpu_f32 = model.prefill(_cast(cpu_params, torch.float32), cpu_tokens)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(card).all()), "card vs CPU: finite logits")

    def gap(a, b):
        return float((a - b).abs().max())
    return {"seed": seed, "layers": cfg.n_layers, "attention_calls": n_attn,
            "prompts": 2, "tokens": CARD_CPU_TOKENS,
            "card_vs_cpu_bf16": gap(card, cpu),
            "card_vs_cpu_f32": gap(card, cpu_f32),
            "cpu_bf16_vs_cpu_f32": gap(cpu, cpu_f32),
            "logit_absmax": float(cpu_f32.abs().max()),
            "argmax_equal": bool((card.argmax(-1) == cpu.argmax(-1)).all()),
            "tolerance": CARD_CPU_TOL, "cpu_seconds": cpu_s}


def phase_prefill_zamba2(torch, seed, results):
    """zamba2-1.2b at full width and depth: the prefill of 4 x 4,096 tokens
    (the main path of both model kernels), then a 512-token prompt's
    last-token logits against teacher-forced decoding (no kernel), and the
    bf16 prefill at cut depth on the card against the CPU."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, gen = _zamba2(torch, seed)
    n_params = _n_params(params)
    B, S = 4, 4096
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    model.prefill(params, tokens[:1, :256])              # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention.tc_launches = 0
    ssd_scan.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    logits = model.prefill(params, tokens)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    tc_launches = flash_attention.tc_launches
    n_attn = cfg.n_layers // cfg.attn_every
    check(tc_launches == n_attn, f"all {n_attn} flash calls of the prefill "
                                 f"took the tensor-core route: {tc_launches}")
    check(launches == {"flash_attention": n_attn,
                       "ssd_scan": cfg.n_layers},
          f"one prefill launched flash attention {n_attn} times and the "
          f"SSD scan {cfg.n_layers} times: {launches}")
    check(logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32,
          "prefill logits [4, 32000] f32")
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_prefill(torch, lambda: model.prefill(params, tokens))
    if prof["flash_kernel_calls"] != "not measured":
        check(prof["flash_kernel_calls"] == {"flash_fwd_wgmma": n_attn,
                                             "flash_fwd": 0},
              f"the profiled prefill's device ran flash_fwd_wgmma {n_attn} "
              f"times and the scalar kernel never: "
              f"{prof['flash_kernel_calls']}")

    # independent check: prefill (both kernels) against teacher-forced
    # decode (ring cache and recurrent update, no kernel) on one 512-token
    # prompt, in f32 (the same weights cast) and in bf16; each bf16 path
    # is also held against the f32 prefill, to see whether one of the two
    # strays further than the other
    n = 512
    prompt = tokens[:1, :n]
    agree = {}

    def gap(a, b):
        return {"max_abs_diff": float((a - b).abs().max()),
                "cosine": float(torch.nn.functional.cosine_similarity(
                    a, b, dim=0))}
    for name, p in (("float32", _cast(params, torch.float32)),
                    ("bfloat16", params)):
        dtype = p["embed"].dtype
        full = model.prefill(p, prompt)[0]
        cache = model.init_cache(1, n, dtype=dtype, device="cuda")
        t1 = time.perf_counter()
        for t in range(n):
            step, cache = model.decode_fn(p, cache, prompt[:, t:t + 1], t)
        torch.cuda.synchronize()
        step = step[0]
        top2 = torch.topk(full, 2).values
        agree[name] = {
            **gap(full, step), "logit_absmax": float(full.abs().max()),
            "top2_margin": float(top2[0] - top2[1]),
            "argmax_equal": int(full.argmax()) == int(step.argmax()),
            "decode_ms_per_step": (time.perf_counter() - t1) / n * 1e3}
        if name == "float32":
            f32_full = full
        else:
            agree[name]["prefill_vs_f32_prefill"] = gap(full, f32_full)
            agree[name]["decode_vs_f32_prefill"] = gap(step, f32_full)
        del p, cache
    agree["float32"]["tolerance"] = PREFILL_DECODE_TOL
    card_cpu = [_card_vs_cpu(torch, seed + i) for i in range(CARD_CPU_DRAWS)]
    rec = {"arch": cfg.name, "params": n_params, "batch": B, "seq": S,
           "flash_attention_launches": launches["flash_attention"],
           "flash_attention_tensor_core_launches": tc_launches,
           "ssd_scan_launches": launches["ssd_scan"],
           "ssd_scan_kernel_launches": 3 * launches["ssd_scan"],
           "wall_ms": wall * 1e3, "device_ms": start.elapsed_time(end),
           "tokens_per_s": B * S / wall, "max_memory_allocated": peak,
           "logits_finite": True, "profile": prof,
           "prefill_vs_decode": {"prompt": n, **agree},
           "card_vs_cpu": card_cpu}
    results["prefill_zamba2"] = rec
    emit("path:prefill_zamba2", **rec)
    worst = max(r["card_vs_cpu_bf16"] for r in card_cpu)
    check(worst <= CARD_CPU_TOL,
          f"bf16 prefill at {CARD_CPU_LAYERS} layers, card vs CPU: max "
          f"|Δlogit| {worst} within {CARD_CPU_TOL}")
    f32 = agree["float32"]
    check(f32["max_abs_diff"] <= PREFILL_DECODE_TOL,
          f"f32 prefill vs teacher-forced decode: max |Δlogit| "
          f"{f32['max_abs_diff']} within {PREFILL_DECODE_TOL}")
    check(f32["argmax_equal"], "f32 prefill and teacher-forced decode agree "
                               "on the argmax")
    return cfg, model, params


def phase_serve_zamba2(torch, rng, results, zamba, telemetry=False):
    """ServeEngine over an 8-shard ElasticDeviceQueue serving zamba2-1.2b:
    32 requests in two bursts with a resize 8 -> 6 between them, against
    a host FIFO admission model.  With ``telemetry`` the queue keeps its
    metrics ring and serves the first burst only (16 requests, the resize,
    a drain): the snapshot's ``waves`` section must hold one row per
    queue wave, each request's enqueue and dequeue counted once, and its
    Prometheus text must parse."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import queue_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serve import Request, ServeEngine
    cfg, model, params = zamba
    slots, max_seq, max_new = 8, 256, 16
    eng = ServeEngine(model, params, 8, max_slots=slots, max_seq=max_seq,
                      telemetry=telemetry, flight_k=100_000, device="cuda")
    queue_waves = [0]
    run = eng.queue.run_waves

    def counted(*ops):
        queue_waves[0] += ops[0].shape[0]
        return run(*ops)
    eng.queue.run_waves = counted
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab, int(rng.integers(16, 65)))], max_new=max_new)
        for i in range(32)]
    if telemetry:                     # the first burst and the resize
        reqs = reqs[:16]
    eng.step()                                   # warm-up: an idle step
    for c in (flash_attention, ssd_scan, queue_scan, hash_route, ring_commit):
        c.launches = 0
    waves0 = queue_waves[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.submit(reqs[:16])
    for _ in range(24):
        eng.step()
    pending = [r.rid for r in reqs[:16] if r.start_step < 0]
    resize_step = eng.step_no
    mig = eng.resize(6)
    check(mig["P_from"] == 8 and mig["P_to"] == 6 and eng.queue.n_shards == 6,
          "resize 8 -> 6")
    check(mig["moved"] == eng.queue.size == len(pending),
          f"the resize kept every queued request ({len(pending)})")
    eng.submit(reqs[16:])
    check(eng.run_until_drained(max_steps=2000), "served to the end")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"queue_scan": queue_scan.launches,
                "hash_route": hash_route.launches,
                "flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches,
                "ring_commit": ring_commit.launches}
    check(launches["queue_scan"] > 0 and launches["hash_route"] > 0,
          f"the queue waves and the resize went through the queue-scan and "
          f"hash-route kernels: {launches}")
    check(launches["ring_commit"] >= queue_waves[0] - waves0 > 0,
          f"every queue wave committed through the ring_commit kernel "
          f"({queue_waves[0] - waves0} waves): {launches}")
    check(all(r.done and len(r.out) == max_new for r in reqs),
          f"all {len(reqs)} requests served with 16 tokens each")
    check(all(r.start_step > resize_step for r in reqs if r.rid in pending),
          "requests queued at the resize started after it")
    _check_fifo_admission(eng, reqs, slots, "serve_zamba2")
    steps = eng.step_no - 1
    tokens = sum(len(r.out) for r in reqs)
    rec = {"arch": cfg.name, "slots": slots, "max_seq": max_seq,
           "requests": len(reqs), "max_new": max_new,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "queue_shards": "8 -> 6", "queued_at_resize": len(pending),
           "migration": {k: mig[k] for k in ("kind", "P_from", "P_to",
                                             "moved", "wave_s", "total_s")},
           "steps": steps, "wall_s": wall,
           "decode_step_ms": wall / steps * 1e3,
           "generated_tokens_per_s": tokens / wall,
           "slot_tokens_per_s": sum(len(r.prompt) - 1 + len(r.out)
                                    for r in reqs) / wall,
           "requests_per_s": len(reqs) / wall, "launches": launches,
           "fifo_admission": "ok", "metrics": eng.metrics()}
    name = "serve_zamba2"
    if telemetry:
        from repro_torch.obs import to_prometheus
        snap = rec["metrics"]
        rows = snap["waves"]
        check(len(rows) == queue_waves[0],
              f"one metrics row per queue wave ({len(rows)} rows, "
              f"{queue_waves[0]} waves)")
        check(sum(r["puts"] for r in rows) == len(reqs)
              and sum(r["gets"] for r in rows) == len(reqs),
              "every request enqueued and dequeued once in the rows")
        check(queue_waves[0] - waves0 == launches["queue_scan"],
              "one queue-scan launch per timed queue wave")
        prom = to_prometheus(snap)
        line = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*(\{[a-z]+="[^"]*"'
                          r'(,[a-z]+="[^"]*")*\})? -?[0-9.e+-]+$')
        bad = [x for x in prom.splitlines() if not line.match(x)]
        check(not bad and "repro_waves_puts" in prom,
              f"the Prometheus text parses ({bad[:3]})")
        off = results["serve_zamba2"]
        rec.update(metrics={k: v for k, v in snap.items() if k != "waves"},
                   rows=len(rows), queue_waves=queue_waves[0],
                   prometheus_lines=len(prom.splitlines()),
                   decode_step_ms_telemetry_off=off["decode_step_ms"],
                   last_rows=rows[-3:])
        name = "serve_telemetry_zamba2"
    results[name] = rec
    emit(f"path:{name}", **rec)



def _check_fifo_admission(eng, reqs, slots: int, what: str) -> None:
    """Admission against the host FIFO model: requests start in enqueue
    order, and each step starts min(free slots, queued) of them."""
    starts = [r.start_step for r in reqs]
    check(starts == sorted(starts), f"{what}: admission follows enqueue "
                                    f"order")
    for s in range(1, eng.step_no + 1):
        busy = sum(0 <= r.start_step < s <= r.finish_step for r in reqs)
        queued = sum(r.enqueue_step < s and not 0 <= r.start_step < s
                     for r in reqs)
        check(sum(r.start_step == s for r in reqs)
              == min(slots - busy, queued),
              f"{what} step {s}: FIFO fills min(free slots, queued)")


def _rid_payload(ids: np.ndarray) -> np.ndarray:
    """The serving engine's queue payload: the request id, then 0."""
    return np.stack([ids, np.zeros_like(ids)], -1).astype(np.int32)


def _capture_bursts(eng) -> list:
    """Keep every queue burst the engine runs: its shard count, staged
    arrays and outputs, as device tensors (read after the run, so the
    capture adds no host sync to the timed steps)."""
    log, q = [], eng.queue
    run = q.run_waves

    def run_waves(*ops):
        out = run(*ops)
        log.append((q.n_shards, ops, out))
        return out
    q.run_waves = run_waves
    return log


def _zamba2_requests(rng, cfg, n, first_rid=0, **kw):
    from repro_torch.serve import Request
    return [Request(rid=first_rid + i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab, int(rng.integers(16, 65)))], max_new=16, **kw)
        for i in range(n)]


def _serve_record(eng, reqs, wall, steps, launches, peak):
    tokens = sum(len(r.out) for r in reqs)
    return {"requests": len(reqs), "steps": steps, "wall_s": wall,
            "decode_step_ms": wall / steps * 1e3,
            "generated_tokens_per_s": tokens / wall,
            "requests_per_s": len(reqs) / wall, "launches": launches,
            "max_memory_allocated": peak, "metrics": eng.metrics()}


EDF_SLOTS, EDF_MAX_SEQ, EDF_HORIZON, EDF_BUCKETS = 8, 256, 64, 8


def _edf_engine(model, params, **kw):
    """The EDF engine of ``path:serve_edf_zamba2`` (8 shards, a bucket
    window of 2 x 8 shards, deferral past it, and an autoscaler that grows
    at the first overloaded step, no shrink in this run) and its
    controller; ``kw`` is ``device=`` or ``runtime=``."""
    from repro_torch.serve import (ControllerConfig, HysteresisController,
                                   ServeEngine)
    ctl = HysteresisController(ControllerConfig(
        high_watermark=0.75, low_watermark=0.0, high_patience=1,
        low_patience=1_000_000, cooldown=0))
    eng = ServeEngine(model, params, 8, max_slots=EDF_SLOTS,
                      max_seq=EDF_MAX_SEQ, queue_cap=2, deadline=True,
                      n_buckets=EDF_BUCKETS, deadline_horizon=EDF_HORIZON,
                      admission="defer", autoscale=ctl, **kw)
    return eng, ctl


def _edf_seap_model():
    """The host Seap model of the EDF engine's request queue."""
    grid = EDF_HORIZON // EDF_BUCKETS
    seeds = [i * grid for i in range(1, EDF_BUCKETS)]
    return SeapChecker(EDF_BUCKETS, 2 * EDF_SLOTS, seeds,
                       payload=_rid_payload), seeds


def _edf_drive(eng, loose, tight):
    """16 loose deadlines, 24 steps, a resize 8 -> 6, 16 tight deadlines,
    a drain.  Returns the ids still queued at the resize and its stats."""
    for i, r in enumerate(loose):
        r.deadline = eng.step_no + 40 + i        # loose: 40-55 steps out
    eng.submit(loose)
    for _ in range(24):
        eng.step()
    pending = [r.rid for r in loose if r.start_step < 0]
    mig = eng.resize(6)
    check(mig["P_from"] == 8 and mig["P_to"] == 6, "resize 8 -> 6")
    check(mig["moved"] == eng.queue.size == len(pending),
          f"the resize kept every queued request ({len(pending)})")
    eng.submit(tight, deadline=2)                # tight: 2 steps out
    check(eng.run_until_drained(max_steps=2000), "served to the end")
    return pending, mig


def _edf_checks(eng, ctl, loose, tight, pending):
    reqs = loose + tight
    check(all(r.done and len(r.out) == 16 for r in reqs),
          "all 32 requests served with 16 tokens each")
    queued = [r for r in loose if r.rid in pending]
    late_loose = min((r.start_step for r in queued), default=None)
    check(late_loose is None or max(r.start_step for r in tight)
          <= late_loose, "the tight deadlines were admitted ahead of the "
                         "loose ones still queued")
    check(ctl.stats["grows"] >= 1 and eng.admission_stats["deferred"] > 0,
          "the tight burst was deferred and the autoscaler grew the queue")


def phase_serve_edf_zamba2(torch, rng, results, zamba):
    """ServeEngine(deadline=True) over an 8-shard ElasticDeviceSeapQueue
    serving zamba2-1.2b with deferral and an autoscaler: 16 requests with
    loose deadlines, a resize 8 -> 6, 16 with tight ones; every queue
    burst against the host Seap model, EDF order within each refill.
    Then the tier mode (4 tiers, relaxation 1) on the same model with 16
    requests, against the host tier model."""
    from repro_torch.kernels.hash_route import hash_route
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import tiered_queue_scan
    from repro_torch.serve import ServeEngine
    cfg, model, params = zamba
    slots, max_seq = EDF_SLOTS, EDF_MAX_SEQ
    eng, ctl = _edf_engine(model, params, device="cuda")
    model_q, seeds = _edf_seap_model()
    loose = _zamba2_requests(rng, cfg, 16)
    tight = _zamba2_requests(rng, cfg, 16, first_rid=16)
    reqs = loose + tight
    eng.step()                                   # warm-up: an idle step
    log = _capture_bursts(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tiered_queue_scan.launches = hash_route.launches = 0
    ring_commit.launches = 0
    t0 = time.perf_counter()
    pending, mig = _edf_drive(eng, loose, tight)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"tiered_queue_scan": tiered_queue_scan.launches,
                "hash_route": hash_route.launches,
                "ring_commit": ring_commit.launches}
    n_waves = 0
    for n_shards, ops, out in log:
        host = [x.cpu().numpy() for x in (*ops, *out)]
        model_q.verify(*host)
        n_waves += host[0].shape[0]
    check(launches["tiered_queue_scan"] == n_waves,
          f"one tiered launch per queue wave ({n_waves} waves): {launches}")
    check(launches["hash_route"] >= 2, "the resize and the autoscaler's "
                                       "grow launched the hash route")
    check(launches["ring_commit"] >= n_waves,
          f"every queue wave committed through the ring_commit kernel "
          f"({n_waves} waves): {launches}")
    _edf_checks(eng, ctl, loose, tight, pending)
    steps = eng.step_no - 1
    rec = {"arch": cfg.name, "slots": slots, "max_seq": max_seq,
           "queue_cap": 2, "n_buckets": EDF_BUCKETS, "seed_bounds": seeds,
           "queue_shards": f"8 -> 6 -> {eng.queue.n_shards}",
           "queued_at_resize": len(pending),
           "migrations": [{k: m[k] for k in ("kind", "P_from", "P_to",
                                             "moved", "wave_s")}
                          for m in eng.queue.migrations],
           "queue_waves": n_waves, "edf_order": "ok",
           "deadline_stats": eng.deadline_stats(),
           "admission_stats": {k: v for k, v in eng.admission_stats.items()
                               if k != "decide_us"},
           "autoscale": ctl.snapshot(),
           **_serve_record(eng, reqs, wall, steps, launches, peak)}
    results["serve_edf_zamba2"] = rec
    emit("path:serve_edf_zamba2", **rec)
    # what the two-process EDF run replays and is held to (not printed)
    results["serve_edf_replay"] = {
        "loose": [[r.rid, r.prompt] for r in loose],
        "tight": [[r.rid, r.prompt] for r in tight],
        "admission": [[r.rid, r.start_step, r.finish_step, r.deadline]
                      for r in reqs],
        "tokens": [r.out for r in reqs]}

    # the tier mode: 8 requests of the lowest tier fill the slots, then
    # 8 of tiers 0-2 queue behind them
    eng = ServeEngine(model, params, 8, max_slots=slots, max_seq=max_seq,
                      priorities=4, relaxation=1, device="cuda")
    model_t = TierChecker(4, None, relaxation=1, payload=_rid_payload)
    first = _zamba2_requests(rng, cfg, 8, prio=3)
    second = _zamba2_requests(rng, cfg, 8, first_rid=8)
    for i, r in enumerate(second):
        r.prio = (0, 0, 0, 1, 1, 2, 2, 0)[i]
    reqs = first + second
    eng.step()
    log = _capture_bursts(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tiered_queue_scan.launches = ring_commit.launches = 0
    t0 = time.perf_counter()
    eng.submit(first)
    eng.step()
    eng.submit(second)
    check(eng.run_until_drained(max_steps=2000), "tiers: served to the end")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_waves = 0
    for n_shards, ops, out in log:
        model_t.verify(*(x.cpu().numpy() for x in (*ops, *out)),
                       n_shards=n_shards)
        n_waves += ops[0].shape[0]
    check(tiered_queue_scan.launches == n_waves,
          "tiers: one tiered launch per queue wave")
    check(ring_commit.launches >= n_waves,
          "tiers: every queue wave committed through the ring_commit kernel")
    check(all(r.done for r in reqs), "tiers: all 16 requests served")
    top = max(r.start_step for r in second if r.prio == 0)
    check(all(top <= r.start_step for r in second if r.prio >= 2),
          "tier 0 admitted before the tiers below its relaxation")
    rec = {"arch": cfg.name, "slots": slots, "priorities": 4,
           "relaxation": 1, "queue_waves": n_waves, "tier_order": "ok",
           "tier_wait_stats": eng.tier_wait_stats(),
           **_serve_record(eng, reqs, wall, eng.step_no - 1,
                           {"tiered_queue_scan": tiered_queue_scan.launches,
                            "ring_commit": ring_commit.launches}, peak)}
    results["serve_tiers_zamba2"] = rec
    emit("path:serve_tiers_zamba2", **rec)


# ------------------------------------------- the relaxed tier resolution --
# One dependent step of the walk, as estimated before the card was asked:
# about eight dependent integer and warp-vote instructions at about 5
# cycles each, at the H100's 1.98 GHz boost clock.  The latency bounds
# below multiply it by the walk's steps (one a dequeue for a sequential
# resolution; the kernel's own passes and events, counted by its clock
# build, for the event-driven walk); the clock build's cycles a step are
# reported beside it.
RELAXED_STEP_CYCLES = 40
SM_CLOCK_HZ = 1.98e9


RING_SHARDS = (64, 48)  # ring_commit's shapes: the bulk cells, churn's


def _ring_wave(torch, rng, n_shards, W=4, L=1_024):
    """(store, recv, junk) of one FIFO wave at the cells' shape: the queue
    filled by a 4-wave burst at 90 % enqueues, then a wave at 50 %
    dispatched and exchanged; recv as the pipelined path passes it, the
    request columns of a request ‖ reply buffer."""
    from repro_torch.dqueue import DeviceQueue
    dev = torch.device("cuda")
    q = DeviceQueue(n_shards, cap=65_536, payload_width=W, ops_per_shard=L,
                    device=dev)
    nL = n_shards * L
    E = torch.from_numpy(rng.random((5, nL)) < np.array(
        [0.9, 0.9, 0.9, 0.9, 0.5])[:, None]).to(dev)
    V = torch.ones((5, nL), dtype=torch.bool, device=dev)
    P = torch.from_numpy(_payload(np.arange(5 * nL)).reshape(5, nL, -1)[
        ..., :W].copy()).to(dev)
    st, *_ = q.run_waves(q.init_state(), E[:4], V[:4], P[:4])
    eng = q.engine
    carry, store = eng.disc.split(st)
    d = eng.disc.dispatch(carry, (E[4], V[4], P[4]))
    recv = eng._exchange(eng._pack_request(d))
    wide = torch.cat([recv, torch.zeros((*recv.shape[:3], 1 + W),
                                        dtype=torch.int32, device=dev)], -1)
    return store, wide[..., :2 + W], q.disc.junk


def phase_ring_commit(torch, rng, results):
    """The Stage-4 commit kernel against its plain version at the cells'
    shapes (64 and 48 shards, 1,024 ops a shard, W = 4, a real dispatch),
    on the pipelined path's strided view and on a contiguous copy: the
    store (junk row aside), every full bit, every row's ok and every GET
    row's value bit for bit, the other rows' replies zero.  Timed: the
    wrapper (CUDA events), the plain version, the bytes bound (the receive
    rows read once, the reply written once); device ms come with the
    profiled phases (phase_scan_device_split)."""
    from repro_torch.kernels.ring_commit import ring_commit, ring_commit_ref
    for n in RING_SHARDS:
        (sv, sf), view, junk = _ring_wave(torch, rng, n)
        W = sv.shape[-1]
        launches0 = ring_commit.launches
        n_get = n_ok = 0
        for name, recv in (("pipelined", view), ("contiguous",
                                                 view.contiguous())):
            (kv, kf), kr, ko = ring_commit((sv.clone(), sf.clone()), recv,
                                           junk, W)
            (pv, pf), pr, _ = ring_commit_ref((sv.clone(), sf.clone()), recv,
                                              junk, W)
            torch.cuda.synchronize()
            get = recv[..., 1] == 2
            check(torch.equal(kv[:, :junk], pv[:, :junk])
                  and torch.equal(kf, pf) and not bool(ko)
                  and torch.equal(kr[..., 0], pr[..., 0])
                  and torch.equal(kr[get], pr[get]) and not kr[~get].any(),
                  f"ring_commit {n} shards ({name}) bit-identical to its "
                  f"plain version")
            n_get, n_ok = int(get.sum()), int(kr[..., 0].sum())
        check(n_ok > 0, f"ring_commit {n} shards: dequeues found values")
        st_k, st_p = (sv.clone(), sf.clone()), (sv.clone(), sf.clone())
        ms, plain = _time_pair(torch,
                               lambda: ring_commit(st_k, view, junk, W),
                               lambda: ring_commit_ref(st_p, view, junk, W))
        rows = n * n * view.shape[2]
        b_ms, b_by = bound(rows * ((2 + W) + (1 + W)) * 4, 0)
        rec = {"n_shards": n, "rows": rows, "W": W, "gets": n_get,
               "gets_ok": n_ok, "bit_identical": True, "max_abs_err": 0,
               "launches": ring_commit.launches - launches0, "ms": ms,
               "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        results[("ring_commit", n)] = rec
        emit("kernel:ring_commit", **rec)


def _relaxed_case(rng, n, P, n_shards, kind, backlog=300_000):
    """(deq, shard_of, avail, firsts) of one wave: half dequeues, tier
    sizes after the enqueues at a ``backlog``-deep queue ("mixed"), all
    tiers empty ("empty"), or heads just below INT32_MAX ("edge")."""
    deq = rng.random(n) < 0.5
    so = (np.arange(n) * n_shards // n).astype(np.int32)
    avail = (np.zeros(P, np.int64) if kind == "empty"
             else rng.integers(backlog // (2 * P), backlog // P + 1, P))
    firsts = rng.integers(0, 1_000_000, P)
    if kind == "edge":
        avail = rng.integers(n // (2 * P), n // P + 1, P)
        firsts = INT32_MAX - rng.integers(0, 64, P)
    return deq, so, avail.astype(np.int32), firsts.astype(np.int32)


def phase_relaxed_kernel(torch, rng, results):
    """The relaxed kernel against its plain version, bit for bit: one
    full wave (65,536 ops, 64 shards, shard-major as the priority path
    sends it) at P = 4 with relaxation 1 and 2, P = 300 with relaxation 2,
    every tier empty (all ⊥), heads at INT32_MAX that wrap mid-step (on 64
    shards and on 48, which do not divide 2^32), a relaxation wider than
    a warp over 1,000 tiers, and 100 shards (the owner table in shared
    memory).  Per case: the dequeues, relaxed serves, the walk model's
    passes and events (``relaxed_walk_model``), the clock build's count of
    the same and its cycles a step, CUDA-event ms beside the plain host
    loop; the profiler's device ms follows in ``phase_scan_device_split``."""
    from repro_torch.kernels.relaxed import (relaxed_deletemin,
                                             relaxed_deletemin_ref,
                                             relaxed_walk_model)
    from repro_torch.kernels.relaxed.kernel import (STATS,
                                                    relaxed_deletemin_kernel)
    dev = torch.device("cuda")
    n = 65_536
    cases = [("p4_k1", 4, 1, "mixed", 64), ("p4_k2", 4, 2, "mixed", 64),
             ("p300_k2", 300, 2, "mixed", 64), ("empty", 4, 1, "empty", 64),
             ("edge", 4, 2, "edge", 64), ("edge_48", 4, 2, "edge", 48),
             ("p1000_k40", 1000, 40, "mixed", 64),
             ("w100_k2", 4, 2, "mixed", 100)]
    for name, P, k, kind, N in cases:
        host = _relaxed_case(rng, n, P, N, kind)
        args = [torch.from_numpy(x).to(dev) for x in host]
        launches0 = relaxed_deletemin.launches
        got = relaxed_deletemin(*args, P, k, N)
        want = relaxed_deletemin_ref(*args, P, k, N)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"relaxed_deletemin {name} bit-identical to its plain version")
        check(relaxed_deletemin.launches == launches0 + 1,
              "one launch a call")
        *_, model = relaxed_walk_model(*(torch.from_numpy(x) for x in host),
                                       P, k, N)
        # the clock build: the same outputs, its steps and cycles
        stats = torch.zeros(STATS, dtype=torch.int64, device=dev)
        clocked = relaxed_deletemin_kernel(*args, P, k, N, stats=stats)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(clocked, want)),
              f"relaxed_deletemin {name}: the clock build agrees")
        steps, relaxed, dry, cycles, wait, wb_cycles, walked, _ = (
            stats.tolist())
        check((steps, relaxed, dry, walked) == (
            model["steps"], model["relaxed"], model["dry"],
            model["dequeues"]),
              f"relaxed_deletemin {name}: the clock build walked the "
              f"model's passes and events")
        n_deq = int(host[0].sum())
        chain = steps + relaxed + dry
        rec = {"case": name, "n": n, "n_prios": P, "relaxation": k,
               "n_shards": N, "dequeues": n_deq, "bit_identical": True,
               "max_abs_err": max_abs_err(got, want),
               "served": int(got[2].sum()), "relaxed": int(got[4]),
               "dry_events": dry, "passes": steps, "chain_steps": chain,
               "model_chain_steps": model["chain_steps"],
               "walk_cycles": cycles, "walk_wait_cycles": wait,
               "write_back_cycles": wb_cycles,
               "cycles_per_step": (cycles - wait) / max(chain, 1),
               "step_cycles_estimate": RELAXED_STEP_CYCLES,
               "launches": relaxed_deletemin.launches - launches0}
        if kind == "empty":
            check(not got[2].any(), "every dequeue of the empty tiers is ⊥")
        if kind == "edge":
            check(bool((got[1][got[2]] < 0).any()), "heads wrapped")
        ms = time_ms(lambda: relaxed_deletemin(*args, P, k, N), 20, torch)
        plain = time_ms(lambda: relaxed_deletemin_ref(*args, P, k, N), 2,
                        torch, warmup=1)
        # bytes: flags, shards, three outputs per op; two int32 inputs and
        # one output per tier; ops: the walk's integer work per dequeue
        b_ms, b_by = bound(14 * n + 12 * P + 4, 20 * n_deq * (k + 1))
        # latency bounds at the 40-cycle estimate, not measured: kept in
        # this record only, beside the measured steps and cycles a step
        step_ms = RELAXED_STEP_CYCLES / SM_CLOCK_HZ * 1e3
        rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   latency_bound_ms_at_estimate=chain * step_ms,
                   latency_bound_sequential_ms_at_estimate=n_deq * step_ms,
                   binds_at_estimate=("latency" if chain * step_ms > b_ms
                                      else b_by))
        results[("relaxed_deletemin", name)] = rec
        emit("kernel:relaxed_deletemin", **rec)


def phase_elastic_relaxed(torch, rng, results):
    """ElasticDevicePriorityQueue at full width with relaxation 1: 64
    shards x 4 tiers x 16,384 slots (the priority path's 67 MB store),
    tier shares 40/30/20/10.  Fill at 65% enqueues to above 1,000,000, a
    50/50 burst, LEAVE 16, JOIN 16, drain to ⊥; every wave against the
    host tier model with relaxation 1, one relaxed launch per wave with
    dequeues (every wave has some), waves/s beside the strict path's."""
    from repro_torch.dqueue import ElasticDevicePriorityQueue
    from repro_torch.kernels.relaxed import relaxed_deletemin
    from repro_torch.kernels.ring_commit import ring_commit
    N, P_, CAP, W, L, K = 64, 4, 16_384, 4, 1_024, 16
    TIER_P = [0.4, 0.3, 0.2, 0.1]
    torch.cuda.reset_peak_memory_stats()
    eq = ElasticDevicePriorityQueue(N, n_prios=P_, relaxation=1, cap=CAP,
                                    payload_width=W, ops_per_shard=L,
                                    device="cuda")
    rt = eq.runtime
    model = TierChecker(P_, TIER_P, relaxation=1)
    bursts, migrations = [], []
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    relaxed_deletemin.launches = ring_commit.launches = 0
    deq_waves = 0

    def burst(p_enq):
        nonlocal deq_waves
        nL = eq.n_shards * L
        staged = model.stage(K, nL, p_enq, rng)
        deq_waves += int((staged[1] & ~staged[0]).any(1).sum())
        args = [torch.from_numpy(x).to(eq.device) for x in staged]
        x0, r0 = rt.n_exchanges, relaxed_deletemin.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eq.run_waves(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(rt.n_exchanges - x0 == K + 1, "K+1 exchanges per burst")
        check(relaxed_deletemin.launches - r0 == K,
              "one relaxed launch per wave")
        rec = model.verify(*staged, *(o.cpu().numpy() for o in out),
                           n_shards=eq.n_shards)
        check(eq.sizes == model.sizes, "tier sizes match the model")
        timing["waves"] += K
        timing["seconds"] += dt
        timing["ops"] += K * nL
        bursts.append({"n_shards": eq.n_shards, "p_enq": p_enq,
                       "seconds": dt, **rec, "size": eq.size})

    while eq.size < 1_000_000:
        burst(0.65)
    backlog = eq.size
    burst(0.5)
    sizes_at_leave = eq.sizes
    check(max(sizes_at_leave) <= 48 * CAP, "every tier fits 48 shards")
    _migrate(eq, rt, eq.shrink, list(range(48, 64)), migrations)  # LEAVE
    _migrate(eq, rt, eq.grow, 16, migrations)                     # JOIN
    n_bottom = 0
    while eq.size > 0 or n_bottom == 0:
        burst(0.0)
        n_bottom += bursts[-1]["bottom"]
    launches = relaxed_deletemin.launches
    check(launches == deq_waves == timing["waves"],
          f"one relaxed launch per wave with dequeues ({launches} for "
          f"{deq_waves})")
    commits = _commit_launches(ring_commit, timing["waves"], len(bursts))
    relaxed = sum(b["relaxed"] for b in bursts)
    check(relaxed > 0, "some serve was relaxed")
    peak = torch.cuda.max_memory_allocated()
    del eq
    strict = results["elastic_priority"]
    rec = {"n_shards": N, "n_prios": P_, "relaxation": 1,
           "cap_per_tier": CAP, "payload_width": W, "ops_per_shard": L,
           "K": K, "tier_shares": TIER_P, "backlog_max": backlog,
           "sizes_at_leave": sizes_at_leave, "bursts": len(bursts),
           "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "strict_waves_per_s": strict["waves_per_s"],
           "ops_per_s": timing["ops"] / timing["seconds"],
           "migrations": migrations, "relaxed_deletemin_launches": launches,
           "ring_commit_launches": commits,
           "waves_with_dequeues": deq_waves, "relaxed_serves": relaxed,
           "bottom_dequeues": n_bottom, "max_memory_allocated": peak,
           "priority_order": "ok (relaxation 1)", "burst_log": bursts}
    results["elastic_relaxed_priority"] = rec
    emit("path:elastic_relaxed_priority", **rec)


# --------------------------------------------------------------- telemetry -
def _check_rows(rows, staged, out, occ0, n_disp, cap_window, L, seq0):
    """The drained metrics rows of one burst against the checked outputs:
    per wave its admitted puts and gets, valid ops, ⊥ count, aux signal
    (the discipline's last output), occupancy per window (the window
    before, plus that wave's admitted enqueues, minus its dequeues) and
    headroom.  ``out`` holds the verified outputs; the window of an op is
    the tier or bucket output, 0 for FIFO."""
    E, V = staged[0], staged[1]
    m, aux = out[n_disp - 1], out[-1]
    win = out[0] if n_disp == 3 else np.zeros_like(E, np.int64)
    occ = np.array(occ0, np.int64)
    check(len(rows) == E.shape[0], "one metrics row per wave")
    for k, r in enumerate(rows):
        puts, gets = V[k] & E[k] & m[k], V[k] & ~E[k] & m[k]
        occ += (np.bincount(win[k][puts], minlength=occ.size)
                - np.bincount(win[k][gets], minlength=occ.size))
        want = {"seq": seq0 + k, "puts": int(puts.sum()),
                "gets": int(gets.sum()), "valid": int(V[k].sum()),
                "bottom": int((V[k] & ~m[k]).sum()),
                "aux": int(aux[k]) if n_disp == 3 else 0,
                "headroom": occ.size * cap_window - int(occ.sum()),
                "width": L, "occ": occ.tolist()}
        check(r == want, f"metrics row {k}: {r} == {want}")
    return occ.tolist()


def phase_telemetry(torch, rng, results):
    """FIFO, priority and Seap at their full sizes with ``metrics=True``:
    every drained row against the checked outputs and the models' sizes,
    K+1 exchanges a burst with the ring on; waves/s with the ring on and
    off, in turns (on, off, ...), 2 bursts a side.  Then ``python -m
    repro_torch.obs --smoke`` on the card."""
    from repro_torch.dqueue import (ElasticDevicePriorityQueue,
                                    ElasticDeviceQueue,
                                    ElasticDeviceSeapQueue)
    L, K, N, SIDE = 1_024, 16, 64, 2
    specs = {
        "fifo": (lambda m: ElasticDeviceQueue(
            N, cap=65_536, payload_width=4, ops_per_shard=L, metrics=m,
            flight_k=K, device="cuda"), lambda: FifoChecker(),
            lambda c, nL: c.stage(K, nL, 0.55, rng), 2, N * 65_536),
        "priority": (lambda m: ElasticDevicePriorityQueue(
            N, n_prios=4, cap=16_384, payload_width=4, ops_per_shard=L,
            metrics=m, flight_k=K, device="cuda"),
            lambda: TierChecker(4, [0.4, 0.3, 0.2, 0.1]),
            lambda c, nL: c.stage(K, nL, 0.55, rng), 3, N * 16_384),
        "seap": (lambda m: ElasticDeviceSeapQueue(
            N, n_buckets=8, cap=16_384, payload_width=4, ops_per_shard=L,
            split_occupancy=SEAP_OCC, seed_bounds=SEAP_SEEDS, metrics=m,
            flight_k=K, device="cuda"),
            lambda: SeapChecker(8, SEAP_OCC, SEAP_SEEDS),
            lambda c, nL: c.stage(K, nL, 0.55, SLACK_1, rng), 3,
            N * 16_384),
    }
    recs = {}
    for name, (make, checker, stage, n_disp, cap_window) in specs.items():
        sides = {on: (make(on), checker()) for on in (True, False)}
        secs = {True: 0.0, False: 0.0}
        rows_checked = 0
        for i in range(2 * SIDE):
            on = i % 2 == 0
            q, model = sides[on]
            occ0 = list(model.sizes) if n_disp == 3 else [model.size]
            staged = stage(model, N * L)
            args = [torch.from_numpy(x).to(q.device) for x in staged]
            x0 = q.runtime.n_exchanges
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = q.run_waves(*args)
            torch.cuda.synchronize()
            secs[on] += time.perf_counter() - t0
            check(q.runtime.n_exchanges - x0 == K + 1,
                  f"{name}: K+1 exchanges a burst (ring {'on' if on else 'off'})")
            host = [o.cpu().numpy() for o in out]
            model.verify(*staged, *host)
            if on:
                _check_rows(q.trajectory(), staged, host, occ0, n_disp,
                            cap_window, L, seq0=K * (i // 2))
                rows_checked += K
            else:
                check(q.trajectory() == [], "no rows with the ring off")
        recs[name] = {"bursts_per_side": SIDE, "K": K,
                      "rows_checked": rows_checked,
                      "waves_per_s_on": SIDE * K / secs[True],
                      "waves_per_s_off": SIDE * K / secs[False],
                      "on_over_off": secs[False] / secs[True]}
        del sides
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                           "--smoke"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(SRC)})
    check(proc.returncode == 0,
          f"python -m repro_torch.obs --smoke on the card: {proc.stderr}")
    smoke = json.loads(proc.stdout)
    check(smoke["ok"] and smoke["smoke"]["device"].startswith("cuda"),
          "the obs CLI ran on the card")
    recs["obs_cli"] = {"ok": smoke["ok"], "device": smoke["smoke"]["device"],
                       "exchanges": smoke["exchanges"],
                       "rows": len(smoke["wave_summaries"]),
                       "summary": proc.stderr.strip().splitlines()[-1]}
    results["telemetry"] = recs
    emit("path:telemetry", **recs)


# -------------------------------------------------- checkpoint and faults --
CKPT_DIR = ROOT / "build" / "smoke_checkpoints"


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_checkpoint_fault(torch, rng, results):
    """Save an elastic FIFO queue at 64 shards with a backlog above
    1,000,000 (its 67 MB store), restore it at 48 shards on the card,
    drain it against the host FIFO model; then ``run_with_restarts`` over
    elastic FIFO bursts with a shard failure (a LEAVE with quarantine, a
    regrow JOIN) and a whole-job failure (a restart from the latest
    checkpoint), the served stream against the host FIFO model."""
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.dqueue import ElasticDeviceQueue
    from repro_torch.fault import FailureInjector, elastic_queue_policy, \
        run_with_restarts
    from repro_torch.kernels.segscan import queue_scan
    N, CAP, W, L, K = 64, 65_536, 4, 1_024, 16
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    eq = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                            device="cuda")
    model = FifoChecker()
    bursts, kept = [], []
    timing = {"waves": 0, "seconds": 0.0, "ops": 0}
    while eq.size < 1_000_000:
        _run_burst(torch, rng, eq, eq.runtime, queue_scan, K, model, timing,
                   bursts, kept, (0.65,), "queue-scan")
    backlog = eq.size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eq.save(CKPT_DIR / "fifo", 1)
    save_s = time.perf_counter() - t0
    written = _dir_bytes(CKPT_DIR / "fifo")
    del eq
    t0 = time.perf_counter()
    rq = ElasticDeviceQueue.restore(CKPT_DIR / "fifo", n_shards=48,
                                    device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    mig = rq.migrations[-1]
    check(rq.n_shards == 48 and rq.size == backlog == model.size
          and mig["moved"] == backlog,
          "restored at 48 shards with every element")
    while rq.size > 0:
        _run_burst(torch, rng, rq, rq.runtime, queue_scan, K, model, timing,
                   bursts, kept, (0.0,), "queue-scan")
    check(model.pending == 0, "drained in FIFO order after the restore")
    del rq

    # run_with_restarts over elastic FIFO bursts
    class Holder:                     # the policy follows a restored queue
        q = None

        def __getattr__(self, name):
            return getattr(self.q, name)
    h = Holder()
    fcap, fN, fK, n_steps, every = 16_384, 64, 4, 12, 4
    h.q = ElasticDeviceQueue(fN, cap=fcap, payload_width=W, ops_per_shard=L,
                             pool_size=fN + 4, device="cuda")
    tree_dir, q_dir = CKPT_DIR / "fault_tree", CKPT_DIR / "fault_queue"
    served, fault = [], {"next_id": 0, "restores": 0}

    def init_state():
        s = latest_step(tree_dir)
        if s is not None:             # roll the queue back with the tree
            rt = h.q.runtime
            h.q = None
            h.q = ElasticDeviceQueue.restore(q_dir, s, runtime=rt)
            fault["restores"] += 1
        return {"served": np.int64(0), "next_id": np.int64(0)}

    def step_fn(state, step):
        del served[int(state["served"]):]          # a replay re-serves
        nxt = int(state["next_id"])
        nL = h.q.n_shards * L
        E = rng.random((fK, nL)) < 0.55
        ids = np.zeros((fK, nL), np.int64)
        ids[E] = np.arange(nxt, nxt + int(E.sum()))
        nxt += int(E.sum())
        pw = np.zeros((fK, nL, W), np.int32)
        pw[..., 0] = ids
        dev = h.q.device
        _, m, dv, dok, _ = h.q.run_waves(
            torch.from_numpy(E).to(dev),
            torch.ones((fK, nL), dtype=torch.bool, device=dev),
            torch.from_numpy(pw).to(dev))
        dok = dok.cpu().numpy()
        served.extend(dv.cpu().numpy()[dok][:, 0].tolist())
        if (step + 1) % every == 0:
            h.q.save(q_dir, step + 1)
        return {"served": np.int64(len(served)), "next_id": np.int64(nxt)}

    inj = FailureInjector(shard_fail_at={3: 5}, fail_at_steps=(9,))
    t0 = time.perf_counter()
    _, metrics = run_with_restarts(
        init_state=init_state, step_fn=step_fn, n_steps=n_steps,
        ckpt_dir=tree_dir, ckpt_every=every, injector=inj,
        elastic=elastic_queue_policy(h, regrow_after=2),
        log=lambda *a: None)
    run_s = time.perf_counter() - t0
    check(metrics == {"restarts": 1, "steps_replayed": 0,
                      "steps_run": n_steps + 1, "leaves": 1, "joins": 1},
          f"the fault accounting: {metrics} (a replayed step counts in "
          f"steps_run; steps_replayed stays 0, as in the reference)")
    check(fault["restores"] == 1 and h.q.n_shards == fN
          and 5 not in h.q.device_ids, "one restore; the LEAVEd shard stays "
                                       "quarantined after the JOIN")
    dev = h.q.device
    while h.q.size > 0:
        nL = h.q.n_shards * L
        _, _, dv, dok, _ = h.q.step(
            torch.zeros(nL, dtype=torch.bool, device=dev),
            torch.ones(nL, dtype=torch.bool, device=dev),
            torch.zeros((nL, W), dtype=torch.int32, device=dev))
        dok = dok.cpu().numpy()
        served.extend(dv.cpu().numpy()[dok][:, 0].tolist())
    check(served == list(range(len(served))) and len(served) > 0,
          "the served stream is the host FIFO model's: every id once, in "
          "order, across the LEAVE, the JOIN and the restart")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rec = {"n_shards": N, "cap": CAP, "payload_width": W,
           "backlog": backlog, "save_s": save_s, "bytes_written": written,
           "restore_s": restore_s, "restored_n_shards": 48,
           "migration": {k: mig[k] for k in ("kind", "P_from", "P_to",
                                             "moved", "wave_s", "total_s")},
           "fifo_order": "ok", "fault": {
               "n_shards": fN, "cap": fcap, "K": fK, "steps": n_steps,
               "ckpt_every": every, "schedule": "shard 5 fails at step 3; "
               "the job fails at step 9", "metrics": metrics,
               "served": len(served), "run_s": run_s,
               "device_ids_after": h.q.device_ids[-4:]}}
    results["checkpoint_fault"] = rec
    emit("path:checkpoint_fault", **rec)


# ------------------------------------------------------- the seed wave ----
def phase_seed_wave(torch, rng, results):
    """``DeviceQueue(fused=False)`` (the reference's five-exchange seed
    wave) against the fused wave on the same waves, 64 shards x 65,536
    slots: outputs and final state bit-identical (junk slot aside), 5
    exchanges a wave against 2 (sequential) and K+1 a burst (pipelined),
    waves/s of each in turns: seed, fused, pipelined, pipelined, fused,
    seed."""
    from repro_torch.dqueue import DeviceQueue
    N, CAP, W, L, K = 64, 65_536, 4, 1_024, 8
    model = FifoChecker()
    staged = [model.stage(K, N * L, p, rng) for p in (0.65, 0.65, 0.5, 0.3)]
    on_card = [[torch.from_numpy(x).cuda() for x in s] for s in staged]
    kinds = {"seed": dict(fused=False), "fused": dict(pipelined=False),
             "pipelined": dict()}
    runs, secs, ex = {}, {k: 0.0 for k in kinds}, {}
    for kind in ("seed", "fused", "pipelined", "pipelined", "fused", "seed"):
        q = DeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                        device="cuda", **kinds[kind])
        st, outs = q.init_state(), []
        x0 = q.runtime.n_exchanges
        for args in on_card:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, *o = q.run_waves(st, *args)
            torch.cuda.synchronize()
            secs[kind] += time.perf_counter() - t0
            outs.append([x.cpu().numpy() for x in o])
        ex[kind] = (q.runtime.n_exchanges - x0) / len(on_card)
        runs[kind] = (outs, st.store_vals[:, :CAP].cpu().numpy(),
                      st.store_full.cpu().numpy(), int(st.first),
                      int(st.last))
        del q, st
    for staged_k, out in zip(staged, runs["seed"][0]):
        model.verify(*staged_k, *out)
    for kind in ("fused", "pipelined"):
        a, b = runs["seed"], runs[kind]
        check(all(np.array_equal(x, y) for ox, oy in zip(a[0], b[0])
                  for x, y in zip(ox, oy)),
              f"seed wave outputs bit-identical to the {kind} wave's")
        check(all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:])),
              f"seed wave final state bit-identical to the {kind} wave's")
    check(ex["seed"] == 5 * K and ex["fused"] == 2 * K
          and ex["pipelined"] == K + 1,
          f"exchanges a burst: seed {ex['seed']}, fused {ex['fused']}, "
          f"pipelined {ex['pipelined']}")
    waves = 2 * K * len(on_card)
    rec = {"n_shards": N, "cap": CAP, "ops_per_shard": L, "K": K,
           "bursts_per_side": 2 * len(on_card),
           "exchanges_per_burst": ex,
           "waves_per_s": {k: waves / s for k, s in secs.items()},
           "fused_over_seed": secs["seed"] / secs["fused"],
           "pipelined_over_seed": secs["seed"] / secs["pipelined"],
           "bit_identical": True, "fifo_order": "ok"}
    results["seed_wave"] = rec
    emit("path:seed_wave", **rec)


# ------------------------------------------------ WorkQueue and runtimes ---
class LeaseModel:
    """Host model of the lease protocol over a FIFO deque of ids: retries
    ahead of submissions, the first ``sum(wants)`` dequeues of a wave
    served in order (a dequeue finds the wave's own enqueues), a lease
    expiring ``lease_steps`` steps after its grant unless acked, seen at
    wave boundaries for leases held before the burst and at the next
    burst for leases granted in it, first ack wins."""

    def __init__(self, lease_steps: int):
        self.lease_steps = lease_steps
        self.queue = deque()         # arrays of ids, in FIFO order
        self.size = 0
        self.leases = {}             # id -> (issued step, worker), in order
        self.completed = set()
        self.reissued = self.duplicate_acks = 0

    def expire(self, step: int) -> list:
        out = [eid for eid, (issued, _) in self.leases.items()
               if step - issued > self.lease_steps
               and eid not in self.completed]
        for eid in out:
            del self.leases[eid]
        self.reissued += len(out)
        return out

    def wave(self, retries, sub_ids, wants, step: int):
        """Enqueue, serve; returns the (workers, ids) granted."""
        for block in (np.asarray(retries, np.int64), sub_ids):
            if block.size:
                self.queue.append(block)
                self.size += block.size
        workers = np.repeat(np.arange(len(wants)), wants)
        take = min(workers.size, self.size)
        ids = _take(self.queue, take)
        self.size -= take
        for eid, w in zip(ids.tolist(), workers[:take].tolist()):
            self.leases[eid] = (step, w)
        return workers[:take], ids

    def ack(self, eid: int) -> bool:
        if eid in self.completed:
            self.duplicate_acks += 1
            return False
        self.completed.add(eid)
        self.leases.pop(eid, None)
        return True


def phase_workqueue(torch, rng, results):
    """``WorkQueue`` over the FIFO configuration, 64 workers, leases of 8
    steps, bursts of 9 waves: a fill to a backlog above 1,000,000, then a
    drain.  Each wave's submissions fill the
    wave beside its dequeues and the model's retries; grants are acked
    0-3 steps later, 2% never, 5% twice.  Grants, retries and stats
    against ``LeaseModel``; every id done exactly once.  The drain ends
    when every lease left is on a completed id: the reference keeps a
    re-grant's lease after its item's first ack (ROADMAP §3)."""
    from repro_torch.dqueue import DeviceQueue, WorkQueue
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import queue_scan
    N, CAP, W, L, K, WORKERS, LEASE = 64, 65_536, 4, 1_024, 9, 64, 8
    n = N * L
    dq = DeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                     device="cuda")
    wq = WorkQueue(dq, lease_steps=LEASE)
    model = LeaseModel(LEASE)
    rt = dq.runtime
    dispatch = dq.run_waves
    ev = []

    def timed_dispatch(*a):           # CUDA events around the dispatch
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = dispatch(*a)
        e1.record()
        ev.append((e0, e1))
        return out
    dq.run_waves = timed_dispatch
    pending = []                      # (due step, id, item), in grant order
    next_id, backlog_max, waves = 0, 0, 0
    bursts, wall, dev_ms = [], 0.0, 0.0
    queue_scan.launches = ring_commit.launches = 0
    x0 = rt.n_exchanges

    def burst(fill: bool):
        nonlocal next_id, backlog_max, waves
        first = wq.step_no + 1
        submits, wants, model_grants = [], [], []
        for k in range(K):
            retries = model.expire(first + k)
            if fill:
                want = rng.integers(0, 64, WORKERS)
                n_sub = n - int(want.sum()) - len(retries)
            else:
                want = np.full(WORKERS, (n - len(retries)) // WORKERS)
                n_sub = 0
            ids = np.arange(next_id, next_id + n_sub, dtype=np.int64)
            next_id += n_sub
            submits.append(_payload(ids))
            wants.append(want.tolist())
            model_grants.append(model.wave(retries, ids, want, first + k))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grants = wq.run_waves(submits, wants)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e0, e1 = ev[-1]
        d_ms = e0.elapsed_time(e1)
        for k, (g, (w_model, id_model)) in enumerate(zip(grants,
                                                         model_grants)):
            got_w = np.array([w for w, _ in g], np.int64)
            got = (np.stack([item for _, item in g]) if g
                   else np.zeros((0, W), np.int32))
            check(np.array_equal(got_w, w_model)
                  and np.array_equal(got, _payload(id_model)),
                  f"wave {first + k}: grants are the lease model's, whole")
            for (w, item), eid in zip(g, id_model.tolist()):
                u = rng.random()
                if u < 0.02:
                    continue                     # never acked
                due = first + k + int(rng.integers(0, 4))
                pending.append((due, eid, item))
                if u > 0.95:
                    pending.append((due + 1, eid, item))   # acked twice
        now = wq.step_no
        keep = []
        for due, eid, item in pending:
            if due <= now:
                check(wq.ack(item) == model.ack(eid), "ack result")
            else:
                keep.append((due, eid, item))
        pending[:] = keep
        check(wq.stats["reissued"] == model.reissued
              and wq.stats["duplicate_acks"] == model.duplicate_acks
              and wq.outstanding == len(model.leases),
              "reissued, duplicate acks and leases equal the model's")
        backlog_max = max(backlog_max, model.size)
        waves += K
        bursts.append({"fill": fill, "seconds": dt, "device_ms": d_ms,
                       "backlog": model.size,
                       "grants": sum(len(g) for g in grants),
                       "outstanding": wq.outstanding})
        return dt, d_ms

    while model.size <= 1_000_000:
        s, d = burst(True)
        wall, dev_ms = wall + s, dev_ms + d
    n_fill = len(bursts)
    # drain until every lease left is on a completed id: the reference
    # keeps such a lease (a re-grant of an item whose first holder acked
    # late) for good, so ``outstanding`` need not reach 0 (ROADMAP §3)
    while model.size > 0 or pending or any(
            eid not in model.completed for eid in model.leases):
        s, d = burst(False)
        wall, dev_ms = wall + s, dev_ms + d
        check(len(bursts) < 200, "the drain ends")
    launches = queue_scan.launches
    check(launches == waves, "one queue-scan launch a wave")
    commits = _commit_launches(ring_commit, waves, len(bursts))
    check(rt.n_exchanges - x0 == len(bursts) * (K + 1),
          "K+1 exchanges a burst")
    check(wq.completed == set(range(next_id))
          and wq.stats["items_done"] == next_id,
          "every id done exactly once")
    check(list(wq.leases) == list(model.leases)
          and set(wq.leases) <= wq.completed,
          "the leases left are the model's, all on completed ids")
    st = wq.state
    check(int(st.last) - int(st.first) + 1 == 0, "the queue drained")
    rec = {"n_shards": N, "cap": CAP, "payload_width": W,
           "ops_per_shard": L, "K": K, "workers": WORKERS,
           "lease_steps": LEASE, "ack_delay_steps": [0, 3],
           "never_acked": 0.02, "acked_twice": 0.05,
           "backlog_max": backlog_max, "items": next_id,
           "bursts": len(bursts), "fill_bursts": n_fill, "waves": waves,
           "waves_per_s": waves / wall,
           "wall_ms_per_burst": 1e3 * wall / len(bursts),
           "device_ms_per_burst": dev_ms / len(bursts),
           "host_ms_per_burst": (1e3 * wall - dev_ms) / len(bursts),
           "stats": dict(wq.stats), "queue_scan_launches": launches,
           "ring_commit_launches": commits,
           "outstanding_after_drain": wq.outstanding,
           "exchanges_per_burst": K + 1, "lease_order": "ok",
           "burst_log": bursts}
    results["workqueue"] = rec
    emit("path:workqueue", **rec)


def phase_sim_runtime(torch, rng, results):
    """``ElasticDeviceQueue`` at the FIFO size on a ``SimRuntime`` (25 µs a
    launch, 80 µs a MiB) whose schedule fails shard 37 at step 4: 12 steps
    of 4-wave bursts under ``run_with_restarts`` with
    ``elastic_queue_policy(regrow_after=2)``, then a drain.  The simulated
    wire time against the formula over the counted launches and bytes;
    one LEAVE, one JOIN, the failed id never back; FIFO order."""
    import shutil

    from repro_torch.dqueue import ElasticDeviceQueue
    from repro_torch.fault import elastic_queue_policy, run_with_restarts
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import queue_scan
    from repro_torch.runtime import LatencyModel, SimRuntime
    N, CAP, W, L, K, STEPS, DEAD = 64, 65_536, 4, 1_024, 4, 12, 37
    lat = LatencyModel(base_us=25.0, per_mib_us=80.0)
    sim = SimRuntime(N + 4, lat, fail_at={4: DEAD}, device="cuda")
    q = ElasticDeviceQueue(N, cap=CAP, payload_width=W, ops_per_shard=L,
                           runtime=sim)
    model = FifoChecker()
    charged = []                        # the formula's terms, in order
    n_mig = 0
    wall = {"seconds": 0.0, "waves": 0}

    def note_migrations():
        nonlocal n_mig
        for m in q.migrations[n_mig:]:
            charged.append(lat.latency_s("all_to_all", m["bytes_moved"]))
            charged.append(2 * lat.latency_s("all_reduce", 4))
        n_mig = len(q.migrations)

    def run_burst(p_enq):
        note_migrations()
        nL = q.n_shards * L
        staged = model.stage(K, nL, p_enq, rng)
        x0 = sim.n_exchanges
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = q.run_waves(*(torch.from_numpy(x).cuda() for x in staged))
        torch.cuda.synchronize()
        wall["seconds"] += time.perf_counter() - t0
        wall["waves"] += K
        check(sim.n_exchanges - x0 == K + 1, "K+1 exchanges a burst")
        charged.append((K + 1) * lat.latency_s(
            "all_to_all", SimRuntime.wave_envelope_bytes(q.n_shards, L, W)))
        model.verify(*staged, *(o.cpu().numpy() for o in out))

    def step_fn(state, step):
        run_burst(0.6)
        return state

    queue_scan.launches = ring_commit.launches = 0
    ckpt = CKPT_DIR / "sim_runtime"
    shutil.rmtree(ckpt, ignore_errors=True)
    _, metrics = run_with_restarts(
        init_state=lambda: {}, step_fn=step_fn, n_steps=STEPS,
        ckpt_dir=ckpt, ckpt_every=100, injector=sim,
        elastic=elastic_queue_policy(q, regrow_after=2),
        log=lambda *a: None)
    shutil.rmtree(ckpt, ignore_errors=True)
    backlog = q.size
    while q.size > 0:
        run_burst(0.0)
    note_migrations()
    launches = queue_scan.launches
    check(metrics == {"restarts": 0, "steps_replayed": 0, "steps_run": STEPS,
                      "leaves": 1, "joins": 1}, f"fault accounting {metrics}")
    check(DEAD in sim.failed_ids and DEAD not in q.device_ids
          and q.n_shards == N, "the failed shard never comes back")
    check(model.pending == 0 and model.size == 0, "drained in FIFO order")
    check(launches == wall["waves"], "one queue-scan launch a wave")
    want = 0.0
    for term in charged:                # the runtime's order of additions
        want += term
    check(abs(sim.sim_time_s - want) <= 1e-12 * want,
          f"simulated wire time {sim.sim_time_s} == formula {want}")
    bursts = wall["waves"] // K
    commits = _commit_launches(ring_commit, wall["waves"], bursts)
    check(sim.counts == {"all_to_all": bursts * (K + 1) + 2,
                         "all_reduce": 4}, f"charged launches {sim.counts}")
    rec = {"n_shards": N, "pool_size": N + 4, "cap": CAP, "K": K,
           "steps": STEPS, "failed_shard": DEAD, "failed_at_step": 4,
           "latency": {"base_us": 25.0, "per_mib_us": 80.0},
           "metrics": metrics, "backlog_after_steps": backlog,
           "bursts": bursts, "waves": wall["waves"],
           "waves_per_s": wall["waves"] / wall["seconds"],
           "sim_time_s": sim.sim_time_s, "formula_s": want,
           "sim_over_wall": sim.sim_time_s / wall["seconds"],
           "collectives": dict(sim.counts),
           "bytes_by_kind": dict(sim.bytes_by_kind),
           "migrations": [{k: m[k] for k in ("kind", "P_from", "P_to",
                                              "moved", "bytes_moved",
                                              "wave_s", "sim_s")}
                          for m in q.migrations],
           "device_ids_after": q.device_ids[-4:],
           "queue_scan_launches": launches, "ring_commit_launches": commits,
           "fifo_order": "ok"}
    results["sim_runtime"] = rec
    emit("path:sim_runtime", **rec)


# the two-process queue paths: the one-process paths' configurations,
# 8-wave bursts, the structures run in this order by one pair of processes
DIST_QUEUES = ("fifo", "lifo", "priority", "relaxed", "seap")
DIST_N, DIST_L, DIST_K, DIST_BACKLOG = 64, 1_024, 8, 1_000_000
DIST_CAPS = {"fifo": 65_536, "lifo": 32_768, "priority": 16_384,
             "relaxed": 16_384, "seap": 16_384}
DIST_SHRINK = list(range(8, 24))     # leaves process 0 with 16, 1 with 32
DIST_TIER_P = [0.4, 0.3, 0.2, 0.1]


def _wire_timers(torch, rt):
    """Wrap ``rt.exchange`` and ``rt.gather`` in synchronised host clocks:
    calls, seconds and bytes this process sends, per seam.  Returns the
    tally; ``del rt.exchange, rt.gather`` restores the methods."""
    wire = {"exchange": [0, 0.0, 0], "gather": [0, 0.0, 0],
            "tensors": set()}

    def timed(name, fn):
        def call(buf, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(buf, *args)
            torch.cuda.synchronize()
            w = wire[name]
            w[0] += 1
            w[1] += time.perf_counter() - t0
            w[2] += buf.numel() * buf.element_size()
            wire["tensors"].add(buf.device.type)
            return out
        return call
    rt.exchange = timed("exchange", rt.exchange)
    rt.gather = timed("gather", rt.gather)
    return wire


def _dist_queue(torch, rt, kind: str, seed: int) -> dict:
    """One structure of ``path:distributed_<kind>`` in this process: 32 of
    the 64 shards on the card, the same waves as its sibling from the same
    seed, every burst's outputs gathered and checked against the host
    model, the exchange budget and the kernels' launches counted."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.dqueue import (ElasticDevicePriorityQueue,
                                    ElasticDeviceQueue,
                                    ElasticDeviceSeapQueue,
                                    ElasticDeviceStack)
    from repro_torch.kernels.relaxed import relaxed_deletemin
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import (queue_scan, stack_scan,
                                             tiered_queue_scan)
    rng = np.random.default_rng([seed, DIST_QUEUES.index(kind)])
    N, W, L, K, CAP = DIST_N, 4, DIST_L, DIST_K, DIST_CAPS[kind]
    lifo, seap = kind == "lifo", kind == "seap"
    tiers = kind in ("priority", "relaxed")
    kw = dict(payload_width=W, ops_per_shard=L, runtime=rt)
    if kind == "fifo":
        q = ElasticDeviceQueue(N, cap=CAP, **kw)
        model, counters = FifoChecker(), {"queue_scan": queue_scan}
    elif lifo:
        q = ElasticDeviceStack(N, cap=CAP, slot_depth=4, **kw)
        model = LifoChecker(max_depth=4_000_000)
        counters = {"stack_scan": stack_scan}
    elif seap:
        q = ElasticDeviceSeapQueue(N, n_buckets=8, cap=CAP,
                                   split_occupancy=SEAP_OCC,
                                   seed_bounds=SEAP_SEEDS, **kw)
        model = SeapChecker(8, SEAP_OCC, SEAP_SEEDS)
        counters = {"tiered_queue_scan": tiered_queue_scan}
    else:
        k = int(kind == "relaxed")
        q = ElasticDevicePriorityQueue(N, n_prios=4, relaxation=k, cap=CAP,
                                       **kw)
        model = TierChecker(4, DIST_TIER_P, relaxation=k)
        counters = {"tiered_queue_scan": tiered_queue_scan}
        if k:
            counters["relaxed_deletemin"] = relaxed_deletemin

    def model_size():
        return (model.depth if lifo else sum(model.sizes) if tiers
                else model.size)
    wire = _wire_timers(torch, rt)
    digest = hashlib.sha256()
    timing = {"waves": 0, "seconds": 0.0, "exchange": 0.0, "exchanges": 0,
              "exchange_bytes": 0, "gather": 0.0, "gathers": 0,
              "gather_bytes": 0}
    migrations, bursts = [], []
    for c in (*counters.values(), ring_commit):
        c.launches = 0
    n_sharded = 4 if kind in ("fifo", "lifo") else 5

    def burst(*stage):
        nL = q.n_shards * L
        staged = model.stage(K, nL, *stage, rng)
        x0, g0 = rt.n_exchanges, rt.n_gathers
        c0 = {n: c.launches for n, c in counters.items()}
        r0 = ring_commit.launches
        (en0, es0, eb0), (gn0, gs0, gb0) = wire["exchange"], wire["gather"]
        rt.sync()
        t0 = time.perf_counter()
        out = q.run_waves(*staged)
        rt.sync()
        dt = time.perf_counter() - t0
        timing["exchange"] += wire["exchange"][1] - es0
        timing["exchanges"] += wire["exchange"][0] - en0
        timing["exchange_bytes"] += wire["exchange"][2] - eb0
        timing["gather"] += wire["gather"][1] - gs0
        timing["gathers"] += wire["gather"][0] - gn0
        timing["gather_bytes"] += wire["gather"][2] - gb0
        check(rt.n_exchanges - x0 == K + 1, "K+1 exchanges a burst")
        check(rt.n_gathers - g0 == K + lifo,
              "one descriptor gather a wave (and the stack's overflow flag)")
        for n, c in counters.items():
            check(c.launches - c0[n] == K, f"one {n} launch a wave")
        # the stack has its own commit; the others run the kernel K + 1
        # times a pipelined burst
        check(ring_commit.launches - r0 == (0 if lifo else K + 1),
              "the ring_commit launches of a burst")
        host = [rt.to_host(o, q.shards, lead=1) for o in out[:n_sharded]]
        if n_sharded == 4:
            host.append(rt.host_reduce(out[4], "any"))
        else:
            host += [rt.to_host(o) for o in out[5:]]
        rec = model.verify(*staged, *host,
                           **({"n_shards": q.n_shards} if tiers else {}))
        for h in host:
            digest.update(np.ascontiguousarray(h).tobytes())
        timing["waves"] += K
        timing["seconds"] += dt
        bursts.append({"n_shards": q.n_shards, "stage": list(stage[:1]),
                       "seconds": dt, **rec})
        check(q.size == model_size(), "size matches the host model")
        if seap or tiers:
            check(q.sizes == model.sizes, "window sizes match the model")
        if seap:
            check(q.directory() == model.directory(),
                  "the directory matches the model")

    def migrate(fn, arg):
        x0, g0, before = rt.n_exchanges, rt.n_gathers, q.size
        _, es0, eb0 = wire["exchange"]
        st = fn(arg)
        check(st["moved"] == before == q.size, "moved == size")
        check(rt.n_exchanges - x0 == 1 and rt.n_gathers - g0 == 1,
              "one exchange and one count gather a migration")
        if seap:
            check(q.directory() == model.directory(),
                  "the migration kept the directory")
        migrations.append({**{k: st[k] for k in (
            "kind", "P_from", "P_to", "moved", "bytes_moved", "wave_s",
            "total_s")}, "exchange_s": wire["exchange"][1] - es0,
            "exchange_send_bytes": wire["exchange"][2] - eb0})

    slack = (SLACK_1,) if seap else ()
    while q.size < DIST_BACKLOG:                         # fill
        burst(0.65, *slack)
    backlog = q.size
    if seap:
        while model.sizes[0] or model.sizes[1]:          # drain the lowest
            burst(0.2, SLACK_1)
        slack = (SLACK_2,)
        while not (model.merges and model.splits):       # drift
            burst(0.65, SLACK_2)
    sizes_at_leave = q.sizes if (seap or tiers) else [q.size]
    check(max(sizes_at_leave) <= (N - len(DIST_SHRINK)) * CAP,
          "every window fits the shards a LEAVE keeps")
    migrate(q.shrink, DIST_SHRINK)                       # LEAVE 16
    burst(0.5, *slack)
    migrate(q.grow, len(DIST_SHRINK))                    # JOIN 16
    ids = [s.id for s in q.shards]
    check(ids == [i for i in range(N) if i not in DIST_SHRINK] + DIST_SHRINK,
          "the JOIN appends the regrown shards: the processes interleave")
    n_bottom = 0
    while q.size > 0 or (kind != "fifo" and n_bottom == 0):  # drain
        burst(0.0, *slack)
        n_bottom += bursts[-1]["bottom"]
    check(model_size() == 0, "drained")
    del rt.exchange, rt.gather
    ex = wire["exchange"]
    rec = {"rank": rt.rank, "kind": kind, "n_shards": N, "cap": CAP,
           "payload_width": W, "ops_per_shard": L, "K": K,
           "shards_per_process": rt.shards_per_process,
           "local_shards_after_join": len(rt.local_shards(q.shards)),
           "active_order_after_join": ids, "backlog_max": backlog,
           "sizes_at_leave": sizes_at_leave,
           "bursts": len(bursts), "waves": timing["waves"],
           "waves_per_s": timing["waves"] / timing["seconds"],
           "exchange_calls": ex[0],
           "exchange_ms_total": 1e3 * ex[1],
           "exchange_ms_per_call": 1e3 * ex[1] / ex[0],
           "exchange_send_bytes_per_call": ex[2] / ex[0],
           "exchange_share_of_bursts": timing["exchange"] / timing["seconds"],
           "burst_exchange_ms_per_call":
               1e3 * timing["exchange"] / timing["exchanges"],
           "burst_exchange_send_bytes_per_call":
               timing["exchange_bytes"] / timing["exchanges"],
           "descriptor_gathers": timing["gathers"],
           "descriptor_gather_ms_per_call":
               1e3 * timing["gather"] / timing["gathers"],
           "descriptor_send_bytes_per_call":
               timing["gather_bytes"] / timing["gathers"],
           "descriptor_share_of_bursts":
               timing["gather"] / timing["seconds"],
           "gathers": rt.n_gathers,
           "launches": {n: c.launches for n, c in counters.items()},
           "ring_commit_launches": ring_commit.launches,
           "backend": dist.get_backend(),
           "wire_tensors": sorted(wire["tensors"]),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "migrations": migrations, "digest": digest.hexdigest(),
           "burst_log": bursts}
    if tiers:
        rec["relaxed_serves"] = sum(b["relaxed"] for b in bursts)
        check((rec["relaxed_serves"] > 0) == (kind == "relaxed"),
              "relaxed serves only with relaxation")
    if seap:
        rec.update(splits=model.splits, merges=model.merges)
    return rec


def _dist_serve(torch, rt, seed: int, spec_path: str) -> dict:
    """One process of ``path:distributed_serve_edf_zamba2``: the EDF
    engine of ``path:serve_edf_zamba2`` on this runtime (its 8 queue
    shards split 4 and 4, then 6 after the resize), zamba2-1.2b from the
    same seed in both processes, replaying the one-process run's requests
    (``spec_path``); every queue burst against the host Seap model."""
    import hashlib

    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import tiered_queue_scan
    from repro_torch.serve import Request
    spec = json.loads(Path(spec_path).read_text())
    cfg, model, params, _ = _zamba2(torch, seed)
    loose = [Request(rid=rid, prompt=p, max_new=16)
             for rid, p in spec["loose"]]
    tight = [Request(rid=rid, prompt=p, max_new=16)
             for rid, p in spec["tight"]]
    reqs = loose + tight
    eng, ctl = _edf_engine(model, params, runtime=rt)
    model_q, _ = _edf_seap_model()
    eng.step()                                   # warm-up: an idle step
    log, q = [], eng.queue
    run = q.run_waves

    def run_waves(*ops):
        out = run(*ops)
        log.append((list(q.shards), ops, out))
        return out
    q.run_waves = run_waves
    wire = _wire_timers(torch, rt)
    tiered_queue_scan.launches = ring_commit.launches = 0
    rt.sync()
    t0 = time.perf_counter()
    pending, mig = _edf_drive(eng, loose, tight)
    rt.sync()
    wall = time.perf_counter() - t0
    del rt.exchange, rt.gather
    launches = tiered_queue_scan.launches
    n_waves = 0
    for shards, ops, out in log:
        host = ([x.numpy() for x in ops]
                + [rt.to_host(o, shards, lead=1) for o in out[:5]]
                + [rt.to_host(o) for o in out[5:]])
        model_q.verify(*host)
        n_waves += host[0].shape[0]
    check(launches == n_waves,
          f"one tiered launch per queue wave ({n_waves} waves): {launches}")
    commits = ring_commit.launches
    check(commits >= n_waves, f"every queue wave committed through the "
                              f"ring_commit kernel ({commits} for "
                              f"{n_waves} waves)")
    _edf_checks(eng, ctl, loose, tight, pending)
    tokens = [r.out for r in reqs]
    ex = wire["exchange"]
    steps = eng.step_no - 1
    return {"rank": rt.rank, "arch": cfg.name,
            "shards_per_process": rt.shards_per_process,
            "queue_shards": f"8 -> 6 -> {eng.queue.n_shards}",
            "local_shards_after": len(rt.local_shards(eng.queue.shards)),
            "queued_at_resize": len(pending),
            "migrations": [{k: m[k] for k in ("kind", "P_from", "P_to",
                                              "moved", "wave_s")}
                           for m in eng.queue.migrations],
            "queue_waves": n_waves, "tiered_queue_scan_launches": launches,
            "ring_commit_launches": commits, "steps": steps, "wall_s": wall,
            "decode_step_ms": wall / steps * 1e3,
            "generated_tokens_per_s": sum(map(len, tokens)) / wall,
            "exchange_calls": ex[0], "exchange_ms_total": 1e3 * ex[1],
            "exchange_ms_per_call": 1e3 * ex[1] / max(1, ex[0]),
            "exchange_send_bytes_per_call": ex[2] / max(1, ex[0]),
            "exchange_share_of_wall": ex[1] / wall,
            "gathers": rt.n_gathers,
            "deadline_stats": eng.deadline_stats(),
            "admission_stats": {k: v for k, v in eng.admission_stats.items()
                                if k != "decide_us"},
            "autoscale": ctl.snapshot(), "edf_order": "ok",
            "admission": [[r.rid, r.start_step, r.finish_step, r.deadline]
                          for r in reqs],
            "tokens": tokens,
            "tokens_digest": hashlib.sha256(
                json.dumps(tokens).encode()).hexdigest(),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def dist_child(what: str, seed: int, spec_path: str = "") -> int:
    """One process of the two-process paths (started by
    ``phase_distributed`` or ``phase_distributed_serve`` through
    ``launch_localhost``): ``what`` is a comma list of DIST_QUEUES, run in
    order, or ``serve_edf``.  Prints one ``DIST_RESULT`` JSON line per
    structure."""
    import torch

    from repro_torch.runtime import DistributedRuntime
    rt = DistributedRuntime.from_env(device="cuda")
    for kind in what.split(","):
        torch.cuda.reset_peak_memory_stats()
        rec = (_dist_serve(torch, rt, seed, spec_path) if kind == "serve_edf"
               else _dist_queue(torch, rt, kind, seed))
        print("DIST_RESULT " + json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    rt.close()
    return 0


def _launch_dist(torch, what: str, seed: int, shards_per_process: int,
                 timeout: float, extra=()) -> tuple:
    """Build the kernels here (no child runs nvcc), start the two
    processes, and return their records by structure, process order, and
    the wall seconds."""
    from repro_torch.kernels import backend
    from repro_torch.runtime import launch_localhost
    backend.build()
    torch.cuda.empty_cache()          # the children share the card
    t0 = time.perf_counter()
    res = launch_localhost(script=str(ROOT / "chip_smoke.py"),
                           args=["--dist-child", what, "--seed", str(seed),
                                 *extra],
                           n_procs=2, shards_per_process=shards_per_process,
                           timeout=timeout)
    wall = time.perf_counter() - t0
    by_kind: dict = {}
    for r in res:
        for line in r.stdout.splitlines():
            if line.startswith("DIST_RESULT "):
                rec = json.loads(line[12:])
                by_kind.setdefault(rec.get("kind", what), []).append(rec)
    check(all(len(v) == 2 for v in by_kind.values())
          and len(by_kind) == len(what.split(",")),
          f"both processes reported every structure: {sorted(by_kind)}")
    return by_kind, wall


def phase_distributed(torch, seed: int, results):
    """Two processes on the card through ``launch_localhost``, 32 of 64
    shards each, gloo on CUDA tensors, one pair for every structure in
    DIST_QUEUES: the FIFO, LIFO, priority (strict and relaxation 1) and
    Seap configurations of the one-process paths, each filled above
    1,000,000 (Seap then drained at its lowest buckets and drifted until a
    merge and a split show), a LEAVE of shard ids 8-23, a 50/50 burst, a
    JOIN of 16 that interleaves the processes' shards, a drain; each
    process checks every burst against the host model, and both print the
    same digest.  One launch (group) of the structure's scan a wave in
    each process, and of the relaxed kernel on the relaxed path."""
    by_kind, wall = _launch_dist(torch, ",".join(DIST_QUEUES), seed,
                                 DIST_N // 2, timeout=600)
    for kind in DIST_QUEUES:
        recs = by_kind[kind]
        check(recs[0]["digest"] == recs[1]["digest"],
              f"{kind}: both processes gathered the same outputs")
        for r in recs:
            check(all(n == r["waves"] for n in r["launches"].values()),
                  f"{kind}: one launch a wave of {sorted(r['launches'])} "
                  f"in each process")
        rec = {"processes": 2,
               "shards_per_process": recs[0]["shards_per_process"],
               "wall_s_all_structures": wall,
               "launches_by_process": {n: [r["launches"][n] for r in recs]
                                       for n in recs[0]["launches"]},
               "ring_commit_launches_by_process": [
                   r["ring_commit_launches"] for r in recs],
               **{k: recs[0][k] for k in recs[0] if k in (
                   "n_shards", "cap", "payload_width", "ops_per_shard", "K",
                   "backlog_max", "sizes_at_leave", "bursts", "waves",
                   "active_order_after_join", "migrations", "backend",
                   "wire_tensors", "digest", "relaxed_serves", "splits",
                   "merges")},
               "per_process": [{k: r[k] for k in (
                   "rank", "local_shards_after_join", "waves_per_s",
                   "exchange_calls", "exchange_ms_total",
                   "exchange_ms_per_call", "exchange_send_bytes_per_call",
                   "exchange_share_of_bursts", "burst_exchange_ms_per_call",
                   "burst_exchange_send_bytes_per_call", "descriptor_gathers",
                   "descriptor_gather_ms_per_call",
                   "descriptor_send_bytes_per_call",
                   "descriptor_share_of_bursts", "gathers",
                   "max_memory_allocated")} for r in recs],
               "order": "ok", "burst_log": recs[0]["burst_log"]}
        results[f"distributed_{kind}"] = rec
        emit(f"path:distributed_{kind}", **rec)


# ----------------------------------------------------- wavecheck, examples --
# the queue cells' full width (PERF.md section 4): 64 shards x 1,024 ops a
# shard (the ladder {256, 512, 1,024}: 43 programs), bursts of 8 (cut from
# the cells' 16 to halve the CPU replay of the narrower bursts; PERF.md 6)
WAVECHECK_SIZES = {"n_shards": 64, "L": 1_024, "W": 4, "K": 8,
                   "n_prios": 4, "n_buckets": 8, "slot_depth": 4,
                   "caps": {"queue": 65_536, "stack": 32_768,
                            "priority": 16_384, "seap": 16_384},
                   "relaxation": 1, "repeats": 3}
# the rebuild bounce at 64 shards on a pool of 80, JOIN 16 and LEAVE 16
WAVECHECK_BOUNCE = {"n_shards": 64, "pool": 80, "grow_by": 16,
                    "cap": 65_536, "W": 4, "L": 1_024, "K_a": 16, "K_b": 8}
WAVECHECK_PROGRAMS = 43
EXAMPLES = ("observability", "priority_serving", "seap_deadlines",
            "serve_queue")


def _cli(args) -> subprocess.Popen:
    """A Python subprocess of the repository, one torch CPU thread: up to
    seven run together on the machine's cores."""
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env={**os.environ, "PYTHONPATH": str(SRC),
                                 "OMP_NUM_THREADS": "1"})


def _wait(proc, timeout: int, what: str):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"check failed: {what} ran over {timeout} s")
    check(proc.returncode == 0,
          f"{what} exited {proc.returncode}: {err[-3000:]}")
    return out, err


def phase_wavecheck(torch, results):
    """wavecheck in torch terms (``repro_torch.analysis.run_all``) at the
    queue cells' full width: every wave program of the four disciplines
    (the priority programs with relaxation 1, so the relaxed kernel runs),
    the seed wave, the SimRuntime twins and the four migrations, each call
    counted through the runtime seam against its budget (2 exchanges a
    step, K + 1 a pipelined burst, 2K a sequential one, 5 the seed wave, 1
    a migration, no gather on one process), its store held in place, and
    the rebuild bounce (64 shards on a pool of 80, JOIN 16, LEAVE 16)
    rebuilding nothing the second time; the last call of each of the 16
    narrower-wave programs (``[compact:w256]``, ``[compact:w512]``: waves
    of 16,384 and 32,768 ops) replayed on the CPU from the same state and
    ops, every output and state field equal (the junk slot aside).  Zero
    violations; each queue kernel launched.  Then ``python -m
    repro_torch.analysis --all`` and ``--selftest`` at 8 shards on the
    card, two subprocesses side by side (``path:wavecheck_cli``)."""
    from repro_torch.analysis import run_all
    from repro_torch.analysis.seam import KERNELS, kernel_launches
    from repro_torch.dqueue.wave_engine import bucket_ladder
    from repro_torch.kernels.relaxed import relaxed_deletemin
    from repro_torch.kernels.ring_commit import ring_commit
    from repro_torch.kernels.segscan import (queue_scan, stack_scan,
                                             tiered_queue_scan)
    sz = WAVECHECK_SIZES
    for fn in (queue_scan, stack_scan, tiered_queue_scan, relaxed_deletemin,
               ring_commit):
        fn.launches = 0
    t0 = time.perf_counter()
    rep = run_all(device="cuda", recompile=WAVECHECK_BOUNCE, **sz)
    wall_s = time.perf_counter() - t0
    launches = kernel_launches()
    check(rep["passed"], f"path:wavecheck: {rep['n_violations']} "
                         f"violations: {rep['violations'][:4]}")
    progs = rep["programs"]
    check(len(progs) == WAVECHECK_PROGRAMS,
          f"path:wavecheck: {len(progs)} programs, not "
          f"{WAVECHECK_PROGRAMS}")
    K = sz["K"]
    for name, p in progs.items():
        ex = p["collectives"]["exchange"]
        want = (5 if "legacy" in name else 1 if "migration" in name
                else K + 1 if "run_waves[pipe" in name
                else 2 * K if "run_waves[seq]" in name else 2)
        check(ex == want and p["collectives"]["gather"] == 0,
              f"path:wavecheck {name}: {p['collectives']}, want {want} "
              f"exchanges and no gather")
    rg = rep["recompile_guard"]
    check(rg["warm_rebuilds"] > 0 and rg["second_bounce_rebuilds"] == 0,
          f"path:wavecheck: rebuild bounce {rg}")
    commits = ring_commit.launches
    check(all(launches[k] > 0 for k in KERNELS) and commits > 0,
          f"path:wavecheck launched every queue kernel: {launches}, "
          f"ring_commit {commits}")
    narrow = bucket_ladder(sz["L"])[:-1]          # 256, 512 at full width
    replayed = {n: p["cpu_replay"] for n, p in progs.items()
                if "cpu_replay" in p}
    check(len(replayed) == 4 * 2 * len(narrow)
          and set(replayed.values()) == {"equal"}
          and all("compact:" in n for n in replayed),
          f"path:wavecheck: the narrower waves equal to the CPU's: "
          f"{replayed}")
    full = f"w{sz['L']}"
    ladder = {kind: {
        "step_ms": {**{f"w{w}": progs[f"{kind}.step[compact:w{w}]"][
            "wall_ms"] for w in narrow},
            full: progs[f"{kind}.step"]["wall_ms"]},
        "pipelined_burst_ms": {**{
            f"w{w}": progs[f"{kind}.run_waves[pipe,compact:w{w}]"][
                "wall_ms"] for w in narrow},
            full: progs[f"{kind}.run_waves[pipe]"]["wall_ms"]}}
        for kind in ("queue", "stack", "priority", "seap")}
    rec = {"sizes": {**sz, "bounce": WAVECHECK_BOUNCE},
           "programs": {n: {"exchange": p["collectives"]["exchange"],
                            "gather": p["collectives"]["gather"],
                            "launches": p["launches"],
                            "wall_ms": p["wall_ms"],
                            "held": p["held"],
                            "donated_leaves": p["donated_leaves"],
                            **{k: p[k] for k in ("cpu_replay_ms",)
                               if k in p}}
                        for n, p in progs.items()},
           "ladder_wall_ms": ladder,
           "recompile_guard": rg,
           "int32_overflow": rep["int32_overflow"],
           "repo_ast_files": len(rep["repo_ast"]["files_checked"]),
           "cpu_replayed": sorted(replayed),
           "launches": launches, "ring_commit_launches": commits,
           "wall_s": wall_s}
    results["wavecheck"] = rec
    emit("path:wavecheck", **rec)

    # the CLI at the reference's shape and the mutation self-test: 35
    # programs with no violation, at least 3 rule families tripped,
    # collective_budget and donation among them
    t0 = time.perf_counter()
    procs = {k: _cli(["-m", "repro_torch.analysis", f"--{k}", "--device",
                      "cuda", "--shards", "8"]) for k in ("all", "selftest")}
    cli = {k: _wait(p, 600, f"python -m repro_torch.analysis --{k}")
           for k, p in procs.items()}
    rep8 = json.loads(cli["all"][0])
    check(rep8["passed"] and len(rep8["programs"]) == 35
          and rep8["device"].startswith("cuda"),
          f"wavecheck --all at 8 shards on the card: "
          f"{rep8['violations'][:4]}, {len(rep8['programs'])} programs")
    st = json.loads(cli["selftest"][0])
    check(st["passed"] and st["n_tripped"] >= 3
          and {"collective_budget", "donation"} <= set(st["tripped_rules"]),
          f"wavecheck --selftest on the card: {st['tripped_rules']}")
    rec = {"all_8_shards": cli["all"][1].strip().splitlines()[-1],
           "selftest": cli["selftest"][1].strip().splitlines()[-1],
           "selftest_tripped": st["tripped_rules"],
           "programs_8_shards": len(rep8["programs"]),
           "wall_s": time.perf_counter() - t0}
    results["wavecheck_cli"] = rec
    emit("path:wavecheck_cli", **rec)


def phase_examples(torch, results):
    """The port's four examples on the card (``examples/torch_*.py``, the
    default device), all started together with the three queue examples
    again on the CPU (``--device cpu``), each with a timeout; each must
    exit 0, and every line a queue example prints on the card must be
    the CPU run's but the two that carry a wall time or a path
    ("[device]", "[trace]"): served orders and tiers, relaxed serves, the
    Seap directory's boundaries, EDF start steps, metrics rows, the
    overflow ramp.  ``serve_queue`` draws its random weights on the
    device, so its tokens differ by device: it must serve all 10
    requests in FIFO admission order.  The observability example's trace
    goes under ``build/``."""
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    procs = {}
    for name in EXAMPLES:
        script = str(ROOT / "examples" / f"torch_{name}.py")
        card, cpu = [script], [script, "--device", "cpu"]
        if name == "observability":
            trace = ROOT / "build" / "wavescope_trace"
            card += ["--trace", f"{trace}_card.json"]
            cpu += ["--trace", f"{trace}_cpu.json"]
        procs[name, "card"] = _cli(card)
        if name != "serve_queue":
            procs[name, "cpu"] = _cli(cpu)
    outs = {(name, where): _wait(p, 300, f"examples/torch_{name}.py on the "
                                         f"{where}")[0]
            for (name, where), p in procs.items()}
    rec = {}
    for name in EXAMPLES:
        out = outs[name, "card"]
        rec[name] = {"lines": len(out.splitlines()),
                     "last": out.strip().splitlines()[-1]}
        if name == "serve_queue":
            check("served 10/10 requests" in out and "on cuda" in out
                  and "order preserved: True" in out,
                  f"examples/torch_serve_queue.py on the card: {out}")
            continue
        card, cpu = ([ln for ln in o.splitlines()
                      if not ln.lstrip().startswith(("[device]", "[trace]"))]
                     for o in (out, outs[name, "cpu"]))
        check(card == cpu and len(card) >= 8,
              f"examples/torch_{name}.py: the card's lines are the CPU's: "
              f"{[a for a, b in zip(card, cpu) if a != b][:3]}")
        rec[name]["lines_equal_to_cpu"] = len(card)
    rec["wall_s"] = time.perf_counter() - t0
    results["examples"] = rec
    emit("path:examples", **rec)


def phase_distributed_serve(torch, seed: int, results):
    """The EDF engine of ``path:serve_edf_zamba2`` in two processes on the
    card (4 of its 8 queue shards each; zamba2-1.2b from the same seed in
    both), replaying that path's requests: the admission order, the
    requests served and the deadline misses must equal the one-process
    run's, and the tokens must be equal in the two processes."""
    one = results["serve_edf_replay"]
    spec = ROOT / "build" / "dist_serve_requests.json"
    spec.parent.mkdir(parents=True, exist_ok=True)
    spec.write_text(json.dumps(one))
    try:
        by_kind, wall = _launch_dist(torch, "serve_edf", seed, 4,
                                     timeout=420, extra=[str(spec)])
    finally:
        spec.unlink()
    recs = by_kind["serve_edf"]
    for r in recs:
        check(r["admission"] == one["admission"],
              "admission order, served requests and deadlines equal the "
              "one-process EDF run's")
        check(r["deadline_stats"] == results["serve_edf_zamba2"][
            "deadline_stats"], "deadline misses equal the one-process run's")
    check(recs[0]["tokens_digest"] == recs[1]["tokens_digest"],
          "both processes generated the same tokens")
    rec = {"processes": 2, "wall_s": wall,
           "tokens_equal_one_process": recs[0]["tokens"] == one["tokens"],
           **{k: recs[0][k] for k in (
               "arch", "shards_per_process", "queue_shards",
               "queued_at_resize", "migrations", "queue_waves", "steps",
               "deadline_stats", "admission_stats", "autoscale",
               "edf_order", "tokens_digest")},
           "one_process_decode_step_ms": results["serve_edf_zamba2"][
               "decode_step_ms"],
           "per_process": [{k: r[k] for k in (
               "rank", "local_shards_after", "tiered_queue_scan_launches",
               "ring_commit_launches",
               "wall_s", "decode_step_ms", "generated_tokens_per_s",
               "exchange_calls", "exchange_ms_total", "exchange_ms_per_call",
               "exchange_send_bytes_per_call", "exchange_share_of_wall",
               "gathers", "max_memory_allocated")} for r in recs]}
    results["distributed_serve_edf_zamba2"] = rec
    emit("path:distributed_serve_edf_zamba2", **rec)


# -------------------------------------------------------------- training --
def _counters() -> dict:
    """The model kernels' wrapper counts (forward launches, tensor-core
    forward launches, backward calls, plain-version calls)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_fwd": flash_attention.launches,
            "flash_fwd_tc": flash_attention.tc_launches,
            "flash_bwd": flash_attention.bwd_launches,
            "flash_bwd_tc": flash_attention.bwd_tc_launches,
            "ssd_fwd": ssd_scan.launches, "ssd_bwd": ssd_scan.bwd_calls,
            "plain": flash_attention.plain_calls + ssd_scan.plain_calls}


def _zero_counters() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    flash_attention.launches = flash_attention.tc_launches = 0
    flash_attention.bwd_launches = flash_attention.plain_calls = 0
    flash_attention.bwd_tc_launches = 0
    ssd_scan.launches = ssd_scan.bwd_calls = ssd_scan.plain_calls = 0


def _expected_counts(cfg, forwards: int, backwards: int) -> dict:
    """Counts the model implies for ``forwards`` forward passes (remat's
    recompute counted as one more) and ``backwards`` backward passes of
    one microbatch each, bf16 with D = 64 (the tensor-core routes)."""
    n_attn = cfg.n_layers // cfg.attn_every
    return {"flash_fwd": forwards * n_attn, "flash_fwd_tc": forwards * n_attn,
            "flash_bwd": backwards * n_attn,
            "flash_bwd_tc": backwards * n_attn,
            "ssd_fwd": forwards * cfg.n_layers,
            "ssd_bwd": backwards * cfg.n_layers, "plain": 0}


def _grad_err(torch, got, want, f32: bool) -> dict:
    """dq, dk, dv against the plain backward, per element: the largest
    |got - want|, each gradient's max |want| and the largest share of the
    limit (FLASH_BWD_* above) that got uses."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        d, w = (a.float() - b.float()).abs(), b.float().abs()
        wmax = float(w.max())
        limit = (FLASH_BWD_F32_REL * wmax if f32 else
                 FLASH_BWD_RTOL * w + FLASH_BWD_ATOL_REL * wmax)
        out[name] = {"max_abs_err": float(d.max()), "max_abs_want": wmax,
                     "share_of_limit": float((d / limit).max())}
    return out


def _sdpa_bwd_ms(torch, q, k, v, do, reps: int, causal: bool = True
                 ) -> float:
    """scaled_dot_product_attention's forward plus backward, minus its
    forward, by CUDA events: the yardstick beside the backward kernel (the
    port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q.shape[1] != k.shape[1]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def both():
        out = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def fwd():
        with torch.no_grad():
            sdpa(q, k, v, is_causal=causal, enable_gqa=gqa)
    return time_ms(both, reps, torch, 2) - time_ms(fwd, reps, torch, 2)


def phase_flash_attention_bwd(torch, results):
    """The flash-attention backward kernels (three launches: dsum, dk/dv,
    dq) against their plain version (the chunked backward) on the same
    device tensors and the same forward output, in the model's
    [B, L, H, D] layout; the first case is the training path's call.  The
    bf16 D 64 and 128 cases must take the wgmma route (by the launcher's
    report, in the wrapper's count and in each direct call, and by the
    kernel names the profiler sees); each case is reached through the
    wrapper's autograd Function once (counted), then timed alone with the
    forward's log-sum-exp, and two calls must give the same bits.  Reports
    the kernels' ptxas registers and spills from the build phase."""
    from repro_torch.kernels.flash_attention import (
        attention_backward_chunked, flash_attention)
    from repro_torch.kernels.flash_attention.kernel import (
        bwd_tc_route, flash_attention_bwd_kernel, flash_attention_kernel,
        tc_route)
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    ptxas = _ptxas_of(results["build"], "flash_attention_bwd",
                      r"(flash_bwd_(?:dot|dkdv_wgmma|dq_wgmma|dkdv|dq))I"
                      r"(13__nv_bfloat16|f)?Li(\d+)E")
    # (case, B, Hq, Hkv, Lq, Lk, D, causal, window, dtype, timing reps)
    cases = [("train_path: zamba2 shared block", 4, 32, 32, 4096, 4096, 64,
              True, None, bf16, 10),
             ("gqa: llama3-8b heads", 1, 32, 8, 4096, 4096, 128, True, None,
              bf16, 5),
             ("sliding window 1024", 2, 32, 32, 4096, 4096, 64, True, 1024,
              bf16, 5),
             ("ragged: Lq < Lk, no multiple of 64", 2, 8, 2, 1000, 1500, 128,
              True, None, bf16, 10),
             ("f32, D 32", 2, 8, 8, 1000, 1000, 32, True, None, f32, 5)
             ] + _family_flash_cases(torch, bwd=True)
    for case, B, Hq, Hkv, Lq, Lk, D, causal, window, dt, reps in cases:
        def rand(L, H):
            return torch.randn(B, L, H, D, generator=gen, device=dev,
                               dtype=dt).transpose(1, 2)
        q, k, v, do = rand(Lq, Hq), rand(Lk, Hkv), rand(Lk, Hkv), rand(Lq, Hq)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        tc = bwd_tc_route(dt, D, Lq, Lk)
        check(tc == (dt == bf16 and D in (64, 128)),
              f"flash_attention_bwd {case}: bf16 at D 64 and 128 takes the "
              f"wgmma route")
        b0, t0 = flash_attention.bwd_launches, flash_attention.bwd_tc_launches
        out = flash_attention(qg, kg, vg, causal=causal, window=window)
        got = torch.autograd.grad(out, (qg, kg, vg), do)
        check(flash_attention.bwd_launches - b0 == 1
              and flash_attention.bwd_tc_launches - t0 == int(tc),
              f"flash_attention_bwd {case}: the autograd Function launched "
              f"the backward kernels on the {'wgmma' if tc else 'mma.sync'} "
              f"route")
        o = out.detach()
        del out, qg, kg, vg
        want = attention_backward_chunked(q, k, v, o, do, causal=causal,
                                          window=window)
        torch.cuda.synchronize()
        err = _grad_err(torch, got, want, dt == f32)
        check(all(g.dtype == dt and g.shape == w.shape
                  for g, w in zip(got, want)),
              f"flash_attention_bwd {case}: shapes and types")
        check(all(e["share_of_limit"] <= 1.0 for e in err.values()),
              f"flash_attention_bwd {case}: every element within its limit "
              f"of the plain backward: {err}")
        del got, want
        lse = torch.empty(B, Hq, Lq, dtype=f32, device=dev)
        flash_attention_kernel(q, k, v, causal=causal, window=window,
                               lse=lse)

        def run():
            return flash_attention_bwd_kernel(q, k, v, o, do, lse,
                                              causal=causal, window=window)
        (first, tc_first), (second, tc_second) = run(), run()
        check(tc_first == tc_second == tc,
              f"flash_attention_bwd {case}: the launcher reports the "
              f"{'wgmma' if tc else 'mma.sync'} route")
        identical = all(torch.equal(a, b) for a, b in zip(first, second))
        check(identical, f"flash_attention_bwd {case}: two calls give the "
                         f"same bits")
        del first, second
        ms = time_ms(run, reps, torch, 2)
        names = (["flash_bwd_dot", "flash_bwd_dkdv_wgmma",
                  "flash_bwd_dq_wgmma"] if tc else
                 ["flash_bwd_dot", "flash_bwd_dkdv", "flash_bwd_dq"])
        calls = _kernel_calls(torch, run)
        check(sorted(calls) == sorted(names),
              f"flash_attention_bwd {case}: the profile shows the route's "
              f"kernels {names}, got {sorted(calls)}")
        plain = time_ms(lambda: attention_backward_chunked(
            q, k, v, o, do, causal=causal, window=window), max(1, reps // 5),
            torch, 1)
        lib = (_sdpa_bwd_ms(torch, q, k, v, do, reps, causal)
               if window is None and (Lq == Lk or not causal) else None)
        pairs = B * Hq * _visible_pairs(Lq, Lk, window, causal)
        size = q.element_size()
        n_bytes = (size * D * (4 * B * Hq * Lq + 4 * B * Hkv * Lk)
                   + 4 * B * Hq * Lq)
        peak = BF16_FLOPS if dt == bf16 else F32_FLOPS
        b_ms, b_by = bound(n_bytes, 10 * D * pairs, peak)
        rec = {"case": case, "B": B, "Hq": Hq, "Hkv": Hkv, "Lq": Lq,
               "Lk": Lk, "D": D, "window": window, "causal": causal,
               "dtype": str(dt).split(".")[-1],
               "forward_route": "flash_fwd_wgmma" if tc_route(dt, D, Lq)
               else "flash_fwd",
               "route": "wgmma" if tc else "mma.sync / f32",
               "kernel": ", ".join(names) + (
                   " (wgmma from TMA rings, P and dS as bf16 hi + lo)" if tc
                   else " (mma.sync m16n8k16, P and dS as bf16 hi + lo)"
                   if dt == bf16 else " (scalar f32)"),
               "ptxas": ({k: r for k, r in ptxas.items()
                          if "wgmma" in k and k.endswith(f"<{D}>")}
                         if tc else "the mma.sync route's, in the build line"),
               "errors": err,
               "max_abs_err": max(e["max_abs_err"] for e in err.values()),
               "tolerance": (f"|d| <= {FLASH_BWD_F32_REL} max|want|"
                             if dt == f32 else
                             f"|d| <= {FLASH_BWD_RTOL} |want| + "
                             f"{FLASH_BWD_ATOL_REL} max|want|"),
               "repeat_bit_identical": identical,
               "ms": ms,
               "device_ms": sum(m for _, m in calls.values()),
               "device_ms_by_kernel": {n: m for n, (_, m) in calls.items()},
               "device_kernels": {n: c for n, (c, _) in calls.items()},
               "kernel_launches_profiled": sum(c for c, _ in calls.values()),
               "plain_ms": plain, "library_ms": lib,
               "library": "scaled_dot_product_attention forward + backward "
                          "minus its forward" if lib is not None else
                          "none: masked alignment differs",
               "flops": 10 * D * pairs, "bytes": n_bytes, "bound_ms": b_ms,
               "bound_by": b_by, "peak": ("989 TFLOP/s bf16" if dt == bf16
                                          else "67 TFLOP/s f32")
               + ", 3.35 TB/s"}
        results.setdefault("flash_attention_bwd", []).append(rec)
        emit("kernel:flash_attention_bwd", **rec)
        del q, k, v, do, o, lse


SSD_BWD_KERNELS = ("ssd_scan_bwd_walk", "ssd_scan_bwd_chunk",
                   "ssd_scan_bwd_finish")


def phase_ssd_scan_bwd(torch, results):
    """The SSD scan's backward kernel on the card (three launches: the
    forward and adjoint state walks, the chunks, the cross-chunk finish)
    through its wrapper against its plain version (three chunked
    scans and a reverse cumulative sum), f32, at the training path's
    shape: xt, loga, dy views of [b, L, H, ...] buffers, B/C [b, L, N] bf16
    as one head shared by all (the model's form: dB and dC the per-head
    gradients summed over the heads in f32).  One call through the
    autograd Function is counted first; two calls must give the same
    bits; the profile must show each of its three kernels launched once a
    call and nothing else (no forward scan, no flip copy)."""
    from repro_torch.kernels.ssd_scan import (ssd_scan,
                                              ssd_scan_backward_ref)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_kernel
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    b, H, L, P, N = 4, 64, 4096, 64, 64
    dt = torch.nn.functional.softplus(torch.randn(b, L, H, generator=gen,
                                                  device=dev))
    xt = (torch.randn(b, L, H, P, generator=gen, device=dev)
          * dt[..., None]).transpose(1, 2)
    loga = (-dt).transpose(1, 2)
    Bm, Cm = ((torch.randn(b, L, N, generator=gen, device=dev) * 0.3)
              .to(torch.bfloat16) for _ in range(2))
    dy = torch.randn(b, L, H, P, generator=gen, device=dev).transpose(1, 2)
    Bh, Ch = Bm[:, None], Cm[:, None]
    ins = [t.detach().requires_grad_() for t in (xt, loga, Bm, Cm)]
    b0, p0 = ssd_scan.bwd_calls, ssd_scan.plain_calls
    y = ssd_scan(ins[0], ins[1], ins[2][:, None], ins[3][:, None])
    torch.autograd.grad(y, ins, dy)
    check(ssd_scan.bwd_calls - b0 == 1 and ssd_scan.plain_calls == p0,
          "ssd_scan_bwd: the autograd Function ran the backward kernel")
    y = y.detach()
    del ins

    def run():
        return ssd_scan_bwd_kernel(xt, loga, Bh, Ch, y, dy)
    got, again = run(), run()
    identical = all(torch.equal(g, a) for g, a in zip(got, again))
    del again
    want = ssd_scan_backward_ref(xt, loga, Bh, Ch, y, dy)
    torch.cuda.synchronize()
    names = ("dxt", "dloga", "dB", "dC")
    rel = {n: float((g - w).abs().max() / w.abs().max())
           for n, g, w in zip(names, got, want)}
    err = {n: float((g - w).abs().max()) for n, g, w in zip(names, got, want)}
    check(all(g.shape == w.shape for g, w in zip(got, want)),
          "ssd_scan_bwd: shapes")
    check(all(r <= SSD_BWD_REL for r in rel.values()),
          f"ssd_scan_bwd: every gradient within {SSD_BWD_REL} of its max: "
          f"{rel}")
    check(identical, "ssd_scan_bwd: two calls give the same bits")
    del got, want
    ms = time_ms(run, 5, torch, 1)
    calls = _kernel_calls(torch, run)
    launched = {n: c for n, (c, _) in calls.items()}
    check(launched == {n: 1.0 for n in SSD_BWD_KERNELS},
          f"ssd_scan_bwd: the profile shows each backward kernel launched "
          f"once a call and nothing else, got {launched}")
    plain = time_ms(lambda: ssd_scan_backward_ref(xt, loga, Bh, Ch, y, dy),
                    1, torch, 1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    # read xt, y, dy (f32), B, C (bf16, one group), loga; write dxt, dloga
    # and dB, dC (f32, one group: the per-head gradients are summed over
    # the heads inside the function)
    n_bytes = (4 * 4 * b * H * L * P + 2 * 2 * b * L * N + 2 * 4 * b * H * L
               + 2 * 4 * b * L * N)
    flops = 3 * 4 * b * H * L * N * P       # three per-token recurrences
    b_ms, b_by = bound(n_bytes, flops, F32_3XTF32_FLOPS)
    rec = {"case": "train_path: zamba2 mamba layer", "b": b, "H": H, "L": L,
           "P": P, "N": N,
           "B/C": "bfloat16, one group [b, 1, L, N] read with stride 0 over "
                  "heads; dB, dC summed over heads in f32",
           "kernel": "ssd_scan_bwd_walk, ssd_scan_bwd_chunk, "
                     "ssd_scan_bwd_finish "
                     "(csrc/ssd_scan_bwd.cu; mma.sync 3xTF32)",
           "ptxas": _ptxas_of(results["build"], "ssd_scan_bwd",
                              r"(ssd_scan_bwd_(?:walk|chunk|finish))"
                              r"(?:I(13__nv_bfloat16|f))?(?:Li(\d+)E)?"),
           "kernel_launches_per_backward": sum(launched.values()),
           "device_kernels": launched,
           "max_abs_err": err, "rel_err": rel, "tolerance_rel": SSD_BWD_REL,
           "repeat_bit_identical": identical,
           "ms": ms,
           "device_ms": sum(m for _, m in calls.values()),
           "device_ms_by_kernel": {n: m for n, (_, m) in calls.items()},
           "scratch_and_outputs_bytes": extra,
           "plain_ms": plain, "library_ms": None,
           "library": "none: no single PyTorch call computes the scan's "
                      "backward",
           "flops": flops, "bytes": n_bytes, "bound_ms": b_ms,
           "bound_by": b_by, "peak": "165 TFLOP/s f32 as 3xTF32, 3.35 TB/s"}
    results["ssd_scan_bwd"] = rec
    emit("kernel:ssd_scan_bwd", **rec)


def _profile_train_step(torch, step_fn, params, opt, batch) -> dict:
    """One train step under torch.profiler: device ms by kind of kernel
    and the device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and ev.self_device_time_total > 0]
    busy = sum(ev.self_device_time_total for ev in evs)
    by_kind = {"flash_attention forward": 0.0,
               "flash_attention backward": 0.0,
               "ssd_scan forward (and remat's recompute)": 0.0,
               "ssd_scan backward": 0.0,
               "cuBLAS products": 0.0,
               "other (elementwise, reductions, copies, optimizer)": 0.0}
    calls = {}
    for ev in evs:
        k, t = ev.key, ev.self_device_time_total / 1e3
        kind = ("flash_attention forward" if "flash_fwd" in k else
                "flash_attention backward" if "flash_bwd" in k else
                "ssd_scan backward" if "ssd_scan_bwd" in k else
                "ssd_scan forward (and remat's recompute)"
                if "ssd_scan" in k else
                "cuBLAS products" if any(w in k.lower() for w in (
                    "nvjet", "gemm", "xmma", "cutlass")) else
                "other (elementwise, reductions, copies, optimizer)")
        by_kind[kind] += t
        m = re.search(r"::(flash_\w+|ssd_scan_\w+)", k)
        if m:
            calls[m.group(1)] = calls.get(m.group(1), 0) + ev.count
    top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:12]
    return {"wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "busy_share": busy / wall_us if busy else "not measured",
            "device_ms_by_kind": by_kind,
            "kernel_calls": calls if busy else "not measured",
            "top_kernels": [{"kernel": ev.key[:120],
                             "device_ms": ev.self_device_time_total / 1e3,
                             "calls": ev.count} for ev in top]}


def phase_train_zamba2(torch, results, zamba):
    """zamba2-1.2b at full width and depth (the prefill phase's weights)
    trained through ``make_train_step``: global batches of 8 x 4,096
    tokens from ``GlobalOrderPipeline`` as 2 microbatches of 4, remat,
    AdamW, 3 steps; every flash and SSD launch, forward and backward,
    counted against what the model implies, and no plain version run;
    then one more step under the profiler."""
    from repro_torch.data import GlobalOrderPipeline
    from repro_torch.train import adamw_init, make_train_step
    cfg, model, params = zamba
    pipe = GlobalOrderPipeline(TRAIN_SEQ, cfg.vocab, TRAIN_BATCH, device="cuda")
    step_fn = make_train_step(model, num_microbatches=TRAIN_MICRO)

    def batch_at(s):
        return {k: v for k, v in pipe.batch_at_step(s).items()
                if k != "sample_indices"}
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, metrics = [], []
    p = params
    _zero_counters()
    for s in range(TRAIN_STEPS):
        batch = batch_at(s)
        t0 = time.perf_counter()
        p, opt, m = step_fn(p, opt, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = _counters()
    peak = torch.cuda.max_memory_allocated()
    passes = TRAIN_STEPS * TRAIN_MICRO
    expect = _expected_counts(cfg, 2 * passes, passes)
    check(counts == expect,
          f"train_zamba2: {TRAIN_STEPS} steps of {TRAIN_MICRO} microbatches "
          f"launched {counts}, the model implies {expect} (remat runs each "
          f"layer's forward twice; no plain version)")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
              and m["grad_norm"] > 0 for m in metrics),
          f"train_zamba2: finite losses and grad norms > 0: {metrics}")
    check(int(opt.step) == TRAIN_STEPS, "train_zamba2: the optimizer's step")
    check(peak <= TRAIN_PEAK_BYTES,
          f"train_zamba2: peak device memory {peak} bytes, above "
          f"{TRAIN_PEAK_BYTES}")
    prof = _profile_train_step(torch, step_fn, p, opt, batch_at(TRAIN_STEPS))
    step_ms = float(np.median(walls[1:]))
    rec = {"arch": cfg.name, "params": _n_params(params),
           "layers": cfg.n_layers,
           "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO, "remat": True, "steps": TRAIN_STEPS,
           "reduced": TRAIN_REDUCED,
           "launches": counts, "expected_launches": expect,
           "metrics": metrics, "step_wall_ms": walls,
           "step_ms_median_after_first": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
           "max_memory_allocated": peak, "profile": prof}
    results["train_zamba2"] = rec
    emit("path:train_zamba2", **rec)


def _train_step_parts(torch, model, params, batch):
    """One train step written out (M = 1): the loss and gradients, the
    learning rate of step 0, and AdamW's update."""
    from repro_torch.train import adamw_init, adamw_update
    from repro_torch.train.optimizer import cosine_lr
    from repro_torch.train.train_step import value_and_grad
    loss, grads = value_and_grad(model, params, batch)
    opt = adamw_init(params)
    lr = cosine_lr(opt.step)
    new, opt, gnorm = adamw_update(params, grads, opt, lr)
    return loss, grads, new, gnorm, lr, opt.m


@contextmanager
def _tf32_off(torch):
    """TF32 off for cuBLAS and cuDNN inside the block (restored after)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{prefix}/{k}")]
    return [(prefix, tree)]


def phase_train_card_vs_cpu(torch, seed, results):
    """One train step of zamba2-1.2b at full width cut to 6 layers, f32
    weights, on the card (the kernels) against the CPU (the plain
    versions), TF32 off: the loss, every gradient leaf and the updated
    parameters and AdamW's first moments, gated (see TRAIN_CPU_*); then
    the same step in bf16, reported."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("zamba2_1p2b"), n_layers=TRAIN_CPU_LAYERS)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    params = model.init_params(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (TRAIN_CPU_BATCH, TRAIN_CPU_TOKENS + 1),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = {}
    with _tf32_off(torch):
        for name, p in (("float32", _cast(params, torch.float32)),
                        ("bfloat16", params)):
            _zero_counters()
            card = _train_step_parts(torch, model, p, batch)
            torch.cuda.synchronize()
            counts = _counters()
            expect = _expected_counts(cfg, 2, 1)
            if name == "float32":     # the scalar routes
                expect["flash_fwd_tc"] = expect["flash_bwd_tc"] = 0
            check(counts == expect, f"train_card_vs_cpu {name}: the card's "
                                    f"step launched {counts}, not {expect}")
            t0 = time.perf_counter()
            cpu = _train_step_parts(torch, model, _to(p, "cpu"),
                                    _to(batch, "cpu"))
            cpu_s = time.perf_counter() - t0
            lr = float(cpu[4])
            grads = {n: float((a.float().cpu() - b.float()).norm()
                              / b.float().norm().clamp(min=1e-30))
                     for (n, a), (_, b) in zip(_flat(card[1]),
                                               _flat(cpu[1]))}
            worst = max(grads, key=grads.get)
            step_gap = max(float((a.float().cpu() - b.float()).abs().max())
                           for (_, a), (_, b) in zip(_flat(card[2]),
                                                     _flat(cpu[2])))
            moments = {n: float((a.cpu() - b).norm()
                                / b.norm().clamp(min=1e-30))
                       for (n, a), (_, b) in zip(_flat(card[5]),
                                                 _flat(cpu[5]))}
            worst_m = max(moments, key=moments.get)
            out[name] = {
                "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
                "loss_gap": abs(float(card[0]) - float(cpu[0])),
                "grad_norm_card": float(card[3]),
                "grad_norm_cpu": float(cpu[3]),
                "grad_rel_err_worst": grads[worst], "worst_leaf": worst,
                "grad_rel_err": grads, "lr": lr,
                "updated_params_max_abs_gap": step_gap,
                "updated_params_gap_in_lr": step_gap / lr,
                "first_moment_rel_err_worst": moments[worst_m],
                "first_moment_worst_leaf": worst_m,
                "launches": counts, "cpu_seconds": cpu_s}
            del card, cpu
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "attention_calls": cfg.n_layers // cfg.attn_every,
           "batch": TRAIN_CPU_BATCH, "tokens": TRAIN_CPU_TOKENS,
           "tf32": False, **out,
           "tolerance": {"loss": TRAIN_CPU_LOSS_TOL,
                         "grad_rel": TRAIN_CPU_GRAD_REL,
                         "first_moment_rel": TRAIN_CPU_GRAD_REL,
                         "updated_params_in_lr": TRAIN_CPU_STEP_LR,
                         "bfloat16": "reported, not gated"}}
    results["train_card_vs_cpu"] = rec
    emit("path:train_card_vs_cpu", **rec)
    f = out["float32"]
    check(f["loss_gap"] <= TRAIN_CPU_LOSS_TOL,
          f"train_card_vs_cpu f32: loss gap {f['loss_gap']}")
    check(f["grad_rel_err_worst"] <= TRAIN_CPU_GRAD_REL,
          f"train_card_vs_cpu f32: gradient {f['worst_leaf']} relative "
          f"error {f['grad_rel_err_worst']}")
    check(f["first_moment_rel_err_worst"] <= TRAIN_CPU_GRAD_REL,
          f"train_card_vs_cpu f32: first moment "
          f"{f['first_moment_worst_leaf']} relative error "
          f"{f['first_moment_rel_err_worst']}")
    check(f["updated_params_gap_in_lr"] <= TRAIN_CPU_STEP_LR,
          f"train_card_vs_cpu f32: updated parameters "
          f"{f['updated_params_gap_in_lr']} learning rates apart")


def phase_train_loop(torch, results):
    """``repro_torch.launch.train.train_loop`` on the card: zamba2-1.2b at
    full width cut to 6 layers, 8 x 1,024 tokens a step, 120 steps, a
    checkpoint every 40 and an injected failure at step 60: the replayed
    steps' losses bit for bit, one restart, the last loss below the
    first; checkpoint bytes and save/restore seconds from the spans."""
    import shutil
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.obs.trace import tracer
    cfg = replace(get_config("zamba2_1p2b"), n_layers=TRAIN_CPU_LAYERS)
    ckpt = CKPT_DIR / "train_loop"
    shutil.rmtree(ckpt, ignore_errors=True)
    tracer.clear()
    _zero_counters()
    t0 = time.perf_counter()
    _, losses, metrics = train_loop(
        cfg, steps=LOOP_STEPS, global_batch=LOOP_BATCH, seq_len=LOOP_SEQ,
        ckpt_dir=ckpt, ckpt_every=LOOP_CKPT_EVERY, fail_at=(LOOP_FAIL_AT,),
        device="cuda", log=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counters()
    steps = [s for s, _ in losses]
    first_run = dict(losses[:LOOP_FAIL_AT])
    replayed = losses[LOOP_FAIL_AT:2 * LOOP_FAIL_AT - LOOP_CKPT_EVERY]
    check(steps == list(range(LOOP_FAIL_AT))
          + list(range(LOOP_CKPT_EVERY, LOOP_STEPS)),
          "train_loop: steps run, with the replay after the restart")
    check(metrics["restarts"] == 1, f"train_loop: one restart: {metrics}")
    identical = all(first_run[s] == loss for s, loss in replayed)
    check(identical, "train_loop: every replayed step's loss bit for bit "
                     "the first run's")
    check(losses[-1][1] < losses[0][1],
          f"train_loop: the loss decreased: {losses[0][1]} -> "
          f"{losses[-1][1]}")
    check(all(np.isfinite(loss) for _, loss in losses),
          "train_loop: finite losses")
    expect = _expected_counts(cfg, 2 * len(losses), len(losses))
    check(counts == expect, f"train_loop: launched {counts}, the model "
                            f"implies {expect}")
    spans = tracer.events()
    saves = [e["dur"] / 1e6 for e in spans if e["name"] == "checkpoint:save"]
    restores = [e["dur"] / 1e6 for e in spans
                if e["name"] == "checkpoint:restore"]
    n_bytes = _dir_bytes(ckpt / f"step_{LOOP_CKPT_EVERY}")
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "global_batch": LOOP_BATCH, "seq": LOOP_SEQ, "steps": LOOP_STEPS,
           "ckpt_every": LOOP_CKPT_EVERY, "fail_at": LOOP_FAIL_AT,
           "steps_run": len(losses), "metrics": metrics,
           "replayed_steps": [s for s, _ in replayed],
           "replay_bit_identical": identical,
           "loss_first": losses[0][1], "loss_last": losses[-1][1],
           "loss_every_10": [loss for s, loss in losses if s % 10 == 0],
           "launches": counts, "checkpoint_bytes": n_bytes,
           "checkpoint_save_s": saves, "checkpoint_restore_s": restores,
           "wall_s": wall, "ms_per_step": wall / len(losses) * 1e3}
    results["train_loop"] = rec
    emit("path:train_loop", **rec)
    shutil.rmtree(ckpt, ignore_errors=True)


# ------------------------------------------------ moe, vlm, encdec paths --
def _family_model(torch, arch: str, seed: int, **over):
    """(cfg, model, params) of ``arch`` (its fields replaced by ``over``)
    with random bf16 weights from ``seed``, on the card."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config(arch), **over)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, model, model.init_params(gen, device="cuda")


class _RouteLog:
    """Records the router's decisions of every MoE layer while active (the
    transformer's ``moe_ffn`` wrapped: ``moe.route`` is run again on the
    same input, outside any timed call): per layer the chosen experts, the
    kept choices, and each token's margin between its k-th and (k+1)-th
    probabilities."""

    def __init__(self, torch):
        self.torch, self.layers = torch, []

    def __enter__(self):
        from repro_torch.models import moe as MOE
        from repro_torch.models import transformer as TF
        real, torch, layers = TF.moe_ffn, self.torch, self.layers

        def moe_ffn(p, x, cfg, capacity_factor=None):
            _, idx, pos, C, _ = MOE.route(p, x, cfg, capacity_factor)
            probs = torch.softmax(x.float() @ p["router"].float(), -1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            layers.append({"experts": idx.sort(-1).values, "kept": pos < C,
                           "margin": top[..., -2] - top[..., -1]})
            return real(p, x, cfg, capacity_factor)
        self._real, TF.moe_ffn = real, moe_ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as TF
        TF.moe_ffn = self._real


def _timed_prefill(torch, fn) -> tuple:
    """(logits, wall ms, device ms by CUDA events, counts) of one call of
    ``fn`` with the kernels' counts set to 0 just before it."""
    torch.cuda.synchronize()
    _zero_counters()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, start.elapsed_time(end), _counters()


def _family_card_vs_cpu(torch, cfg, model, params, inputs: dict,
                        routes: bool = False) -> dict:
    """The f32 prefill (weights cast from ``params``) on the card, TF32
    off, against the same prefill on the CPU: max |Δlogit|, and with
    ``routes`` every MoE token whose chosen experts differ (with its
    margins on both sides)."""
    p32 = _cast(params, torch.float32)
    with _tf32_off(torch):
        _zero_counters()
        with _RouteLog(torch) as card_log:
            card = model.prefill(p32, **inputs).cpu()
        counts = _counters()
    cpu_p, cpu_in = _to(p32, "cpu"), _to(inputs, "cpu")
    del p32
    t0 = time.perf_counter()
    with _RouteLog(torch) as cpu_log:
        cpu = model.prefill(cpu_p, **cpu_in)
    cpu_s = time.perf_counter() - t0
    del cpu_p
    check(bool(torch.isfinite(card).all()), f"{cfg.name} card vs CPU: "
                                            f"finite logits")
    rec = {"layers": cfg.n_layers, "dtype": "float32", "tf32": False,
           "max_abs_logit_diff": float((card - cpu).abs().max()),
           "logit_absmax": float(cpu.abs().max()),
           "argmax_equal": bool((card.argmax(-1) == cpu.argmax(-1)).all()),
           "launches": counts, "cpu_seconds": cpu_s}
    if routes:
        flips, margins = [], []
        for layer, (a, b) in enumerate(zip(card_log.layers, cpu_log.layers)):
            differ = (a["experts"].cpu() != b["experts"]).any(-1)
            margins.append(float(b["margin"].min()))
            for row, tok in differ.nonzero().tolist():
                flips.append({"layer": layer, "row": row, "token": tok,
                              "margin_card": float(a["margin"][row, tok]),
                              "margin_cpu": float(b["margin"][row, tok])})
        rec.update(routed_tokens=sum(int(x["experts"].shape[0]
                                         * x["experts"].shape[1])
                                     for x in cpu_log.layers),
                   expert_set_flips=flips,
                   smallest_margin_by_layer=margins,
                   kept_equal=all(bool((a["kept"].cpu() == b["kept"]).all())
                                  for a, b in zip(card_log.layers,
                                                  cpu_log.layers)))
    return rec


def phase_prefill_granite_moe(torch, seed, results):
    """granite-moe-1b-a400m at full width and depth (24 layers, 32 experts,
    top-8, capacity factor 1.25; random weights from the seed): the
    prefill of 4 x 4,096 tokens, its 24 flash calls all on the
    tensor-core route, the profile by kernel and the share of (token,
    choice) pairs the capacity drops; then, cut to 2 layers, the f32
    prefill on the card against the CPU, chosen experts first."""
    from repro_torch.models.moe import capacity
    cfg, model, params = _family_model(torch, "granite_moe_1b", seed + 20)
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    B, S = MOE_PREFILL
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    model.prefill(params, tokens[:1, :256])              # warm-up
    torch.cuda.reset_peak_memory_stats()
    logits, wall, dev_ms, counts = _timed_prefill(
        torch, lambda: model.prefill(params, tokens))
    peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    expect = {**_no_launches(), "flash_fwd": n, "flash_fwd_tc": n}
    check(counts == expect, f"prefill_granite_moe: launched {counts}, the "
                            f"model implies {expect}")
    check(logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "prefill_granite_moe: finite f32 logits [4, vocab]")
    prof = _profile_prefill(torch, lambda: model.prefill(params, tokens))
    if prof["flash_kernel_calls"] != "not measured":
        check(prof["flash_kernel_calls"] == {"flash_fwd_wgmma": n,
                                             "flash_fwd": 0},
              f"prefill_granite_moe: the device ran "
              f"{prof['flash_kernel_calls']}")
    with _RouteLog(torch) as log:
        model.prefill(params, tokens)
    kept = torch.stack([x["kept"] for x in log.layers])   # [L, B, S, K]
    drop_by_layer = (1 - kept.float().mean((1, 2, 3))).tolist()
    card_cpu = _family_card_vs_cpu(
        torch, *_family_model(torch, "granite_moe_1b", seed + 22,
                              n_layers=2),
        {"tokens": torch.randint(0, cfg.vocab, MOE_CPU_TOKENS, generator=gen,
                                 device="cuda")}, routes=True)
    rec = {"arch": cfg.name, "params": _n_params(params), "layers": n,
           "experts": cfg.n_experts, "top_k": cfg.top_k,
           "capacity_factor": cfg.capacity_factor,
           "capacity_per_expert_per_row": capacity(cfg, S),
           "batch": B, "seq": S, "launches": counts, "wall_ms": wall,
           "device_ms": dev_ms, "tokens_per_s": B * S / wall * 1e3,
           "max_memory_allocated": peak,
           "dropped_share": float(1 - kept.float().mean()),
           "dropped_share_by_layer": drop_by_layer, "profile": prof,
           "card_vs_cpu": {**card_cpu, "batch": MOE_CPU_TOKENS[0],
                           "tokens": MOE_CPU_TOKENS[1],
                           "tolerance": MOE_CPU_TOL,
                           "flip_margin_limit": MOE_FLIP_MARGIN}}
    results["prefill_granite_moe"] = rec
    emit("path:prefill_granite_moe", **rec)
    check(all(f["margin_cpu"] <= MOE_FLIP_MARGIN
              for f in card_cpu["expert_set_flips"]),
          f"prefill_granite_moe card vs CPU: every token whose experts "
          f"differ is a near tie: {card_cpu['expert_set_flips']}")
    check(card_cpu["max_abs_logit_diff"] <= MOE_CPU_TOL,
          f"prefill_granite_moe card vs CPU: max |Δlogit| "
          f"{card_cpu['max_abs_logit_diff']} within {MOE_CPU_TOL}")
    return cfg, model, params


def phase_serve_granite_moe(torch, rng, results, bundle):
    """ServeEngine in FIFO mode serving granite-moe-1b (full size): 8
    slots, 16 requests of 16-64-token prompts and 16 new tokens each (as
    the zamba2 paths draw them), decoded through ``decode_fn`` (at S = 1
    the capacity is 1 and no choice drops); FIFO admission against the
    host model of path:serve_zamba2."""
    from repro_torch.kernels.segscan import queue_scan
    from repro_torch.serve import ServeEngine
    cfg, model, params = bundle
    slots = 8
    eng = ServeEngine(model, params, 8, max_slots=slots, max_seq=256,
                      flight_k=100_000, device="cuda")
    reqs = _zamba2_requests(rng, cfg, 16)
    eng.step()                                   # warm-up: an idle step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    queue_scan.launches = 0
    t0 = time.perf_counter()
    eng.submit(reqs)
    check(eng.run_until_drained(max_steps=2000), "served to the end")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**_counters(), "queue_scan": queue_scan.launches}
    check(counts["queue_scan"] > 0 and counts["plain"] == 0
          and counts["flash_fwd"] == 0,
          f"serve_granite_moe: the queue waves went through the queue-scan "
          f"kernel and decode ran no flash call: {counts}")
    check(all(r.done and len(r.out) == 16 for r in reqs),
          "serve_granite_moe: every request served with 16 tokens")
    _check_fifo_admission(eng, reqs, slots, "serve_granite_moe")
    rec = {"arch": cfg.name, "slots": slots, **_serve_record(
        eng, reqs, wall, eng.step_no - 1, counts,
        torch.cuda.max_memory_allocated()),
        "prompt_lens": [len(r.prompt) for r in reqs],
        "fifo_admission": "ok"}
    results["serve_granite_moe"] = rec
    emit("path:serve_granite_moe", **rec)


def _no_launches() -> dict:
    return {"flash_fwd": 0, "flash_fwd_tc": 0, "flash_bwd": 0,
            "flash_bwd_tc": 0, "ssd_fwd": 0, "ssd_bwd": 0, "plain": 0}


def _train_family(torch, results, name, bundle, batch_at, attn_calls,
                  extra=None):
    """``make_train_step`` over ``bundle``'s model: TRAIN_STEPS steps of
    ``batch_at(step)`` as TRAIN_MICRO microbatches, remat, AdamW; every
    flash launch counted against ``attn_calls`` attention calls a forward
    (remat runs each forward twice), no plain version; one more step
    profiled."""
    from repro_torch.train import adamw_init, make_train_step
    cfg, model, params = bundle
    step_fn = make_train_step(model, num_microbatches=TRAIN_MICRO)
    opt = adamw_init(params)
    batches = [batch_at(s) for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, metrics, p = [], [], params
    _zero_counters()
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        p, opt, m = step_fn(p, opt, batches[s])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = _counters()
    peak = torch.cuda.max_memory_allocated()
    passes = TRAIN_STEPS * TRAIN_MICRO
    n = attn_calls * passes
    expect = {**_no_launches(), "flash_fwd": 2 * n, "flash_fwd_tc": 2 * n,
              "flash_bwd": n, "flash_bwd_tc": n}
    check(counts == expect, f"{name}: {TRAIN_STEPS} steps of {TRAIN_MICRO} "
                            f"microbatches launched {counts}, the model "
                            f"implies {expect}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
              and m["grad_norm"] > 0 for m in metrics),
          f"{name}: finite losses and grad norms > 0: {metrics}")
    check(int(opt.step) == TRAIN_STEPS, f"{name}: the optimizer's step")
    prof = _profile_train_step(torch, step_fn, p, opt, batches[-1])
    step_ms = float(np.median(walls[1:]))
    tokens = batches[0]["tokens"].numel()
    rec = {"arch": cfg.name, "params": _n_params(params),
           "layers": cfg.n_layers, "global_batch": TRAIN_BATCH,
           "seq": batches[0]["tokens"].shape[1], "microbatches": TRAIN_MICRO,
           "remat": True, "steps": TRAIN_STEPS, "launches": counts,
           "expected_launches": expect, "metrics": metrics,
           "step_wall_ms": walls, "step_ms_median_after_first": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "max_memory_allocated": peak, "profile": prof, **(extra or {})}
    results[name] = rec
    emit(f"path:{name}", **rec)
    return rec


def phase_train_granite_moe(torch, results, bundle):
    """granite-moe-1b at full width and depth (the prefill phase's
    weights) trained through ``make_train_step``: 8 x 4,096 tokens from
    ``GlobalOrderPipeline`` as 2 microbatches, remat, AdamW, 3 steps; the
    aux loss > 0 and in the loss (NLL + 0.01 aux, one microbatch without
    grad)."""
    from repro_torch.data import GlobalOrderPipeline
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import chunked_xent
    cfg, model, params = bundle
    pipe = GlobalOrderPipeline(TRAIN_SEQ, cfg.vocab, TRAIN_BATCH,
                               device="cuda")

    def batch_at(s):
        return {k: v for k, v in pipe.batch_at_step(s).items()
                if k != "sample_indices"}
    mb = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in batch_at(0).items()}
    with torch.no_grad():
        h, aux = TF.forward_aux(params, cfg, mb["tokens"], remat=False)
        nll = chunked_xent(h, params["unembed"], mb["targets"])
        loss = model.loss_fn(params, mb, remat=False)
    del h
    aux, nll, loss = float(aux), float(nll), float(loss)
    check(aux > 0 and abs(loss - (nll + 0.01 * aux)) <= 1e-6 * abs(loss),
          f"train_granite_moe: the loss {loss} is the NLL {nll} + 0.01 x "
          f"aux {aux}, aux > 0")
    _train_family(torch, results, "train_granite_moe", bundle, batch_at,
                  cfg.n_layers, extra={"reduced": TRAIN_REDUCED,
                                       "aux_first_microbatch": aux,
                                       "nll_first_microbatch": nll,
                                       "loss_first_microbatch": loss})


def phase_prefill_whisper_small(torch, seed, results):
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers; random weights from the seed): the prefill of 8 sequences of
    1,500 stub frames and 448 decoder tokens (Whisper's text context):
    36 flash calls, 12 bidirectional over the frames, 12 causal over the
    tokens, 12 cross-attention, all on the tensor-core route; then, cut to
    2 + 2 layers, the f32 prefill on the card against the CPU."""
    cfg, model, params = _family_model(torch, "whisper_small", seed + 30)
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    B, T, S = WHISPER_PREFILL_BATCH, cfg.enc_seq, WHISPER_TEXT
    frames = torch.randn(B, T, cfg.d_model, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    model.prefill(params, tokens[:1], frames=frames[:1])   # warm-up
    torch.cuda.reset_peak_memory_stats()
    logits, wall, dev_ms, counts = _timed_prefill(
        torch, lambda: model.prefill(params, tokens, frames=frames))
    peak = torch.cuda.max_memory_allocated()
    n = cfg.enc_layers + 2 * cfg.n_layers
    expect = {**_no_launches(), "flash_fwd": n, "flash_fwd_tc": n}
    check(counts == expect, f"prefill_whisper_small: launched {counts}, "
                            f"the model implies {expect}")
    check(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(
        logits).all()), "prefill_whisper_small: finite logits [8, vocab]")
    prof = _profile_prefill(torch, lambda: model.prefill(params, tokens,
                                                         frames=frames))
    if prof["flash_kernel_calls"] != "not measured":
        check(prof["flash_kernel_calls"] == {"flash_fwd_wgmma": n,
                                             "flash_fwd": 0},
              f"prefill_whisper_small: the device ran "
              f"{prof['flash_kernel_calls']}")
    cpu_b = 2
    card_cpu = _family_card_vs_cpu(
        torch, *_family_model(torch, "whisper_small", seed + 32,
                              n_layers=2, enc_layers=2),
        {"tokens": tokens[:cpu_b], "frames": frames[:cpu_b]})
    rec = {"arch": cfg.name, "params": _n_params(params),
           "layers": {"encoder": cfg.enc_layers, "decoder": cfg.n_layers},
           "batch": B, "frames": T, "text": S, "launches": counts,
           "wall_ms": wall, "device_ms": dev_ms,
           "tokens_per_s": B * S / wall * 1e3,
           "frames_per_s": B * T / wall * 1e3,
           "max_memory_allocated": peak, "profile": prof,
           "card_vs_cpu": {**card_cpu, "batch": cpu_b,
                           "tolerance": WHISPER_CPU_TOL}}
    results["prefill_whisper_small"] = rec
    emit("path:prefill_whisper_small", **rec)
    check(card_cpu["max_abs_logit_diff"] <= WHISPER_CPU_TOL,
          f"prefill_whisper_small card vs CPU: max |Δlogit| "
          f"{card_cpu['max_abs_logit_diff']} within {WHISPER_CPU_TOL}")
    return cfg, model, params


def phase_train_whisper_small(torch, results, bundle):
    """whisper-small at full size trained through ``make_train_step``: 8
    sequences of 448 tokens (``GlobalOrderPipeline``) against 1,500 stub
    frames each (drawn as the training loop draws them), 2
    microbatches, remat, AdamW, 3 steps."""
    from repro_torch.data import GlobalOrderPipeline
    from repro_torch.launch.train import stub_inputs
    cfg, model, params = bundle
    pipe = GlobalOrderPipeline(WHISPER_TEXT, cfg.vocab, TRAIN_BATCH,
                               device="cuda")

    def batch_at(s):
        batch = {k: v for k, v in pipe.batch_at_step(s).items()
                 if k != "sample_indices"}
        return {**batch, **stub_inputs(cfg, s, TRAIN_BATCH, "cuda")}
    _train_family(torch, results, "train_whisper_small", bundle, batch_at,
                  cfg.enc_layers + 2 * cfg.n_layers,
                  extra={"frames": cfg.enc_seq, "reduced": TRAIN_REDUCED
                         + f"; {WHISPER_TEXT} decoder tokens, Whisper's "
                           f"text context, in place of 4,096"})


def phase_prefill_llava_next_34b(torch, seed, results):
    """llava-next-34b at published widths, its depth cut from 60 to
    LLAVA_LAYERS layers (random weights from the seed): the prefill of 2
    sequences of 2,880 stub vision embeddings and 1,216 text tokens (the
    reference's train_4k split), LLAVA_LAYERS flash calls on the
    tensor-core route at D 128, G 7; the loss on the text slice; then, cut
    to 2 layers, the f32 prefill on the card against the CPU."""
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import chunked_xent
    cfg, model, params = _family_model(torch, "llava_next_34b", seed + 40,
                                       n_layers=LLAVA_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    B, V, S = 2, cfg.n_vision_tokens, LLAVA_TEXT
    vis = torch.randn(B, V, cfg.d_model, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
             "vision_embeds": vis}
    model.prefill(params, batch["tokens"][:1, :64], vision_embeds=vis[:1])
    torch.cuda.reset_peak_memory_stats()
    logits, wall, dev_ms, counts = _timed_prefill(
        torch, lambda: model.prefill(params, batch["tokens"],
                                     vision_embeds=vis))
    peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers
    expect = {**_no_launches(), "flash_fwd": n, "flash_fwd_tc": n}
    check(counts == expect, f"prefill_llava_next_34b: launched {counts}, "
                            f"the model implies {expect}")
    check(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(
        logits).all()), "prefill_llava_next_34b: finite logits [2, vocab]")
    prof = _profile_prefill(torch, lambda: model.prefill(
        params, batch["tokens"], vision_embeds=vis))
    with torch.no_grad():
        loss = float(model.loss_fn(params, batch, remat=False))
        h = TF.forward(params, cfg, batch["tokens"], vis, remat=False)
        text = float(chunked_xent(h[:, V:], params["unembed"],
                                  batch["targets"]))
    del h
    check(np.isfinite(loss) and loss == text,
          f"prefill_llava_next_34b: the loss {loss} is the NLL of the text "
          f"slice {text}")
    card_cpu = _family_card_vs_cpu(
        torch, *_family_model(torch, "llava_next_34b", seed + 42,
                              n_layers=2),
        {"tokens": batch["tokens"][:1, :LLAVA_CPU[1]],
         "vision_embeds": vis[:1, :LLAVA_CPU[0]]})
    rec = {"arch": cfg.name, "params": _n_params(params), "layers": n,
           "reduced": f"depth 60 -> {n} layers (full depth is 68.7 GB of "
                      f"bf16 weights)",
           "batch": B, "vision_tokens": V, "text_tokens": S,
           "launches": counts, "wall_ms": wall, "device_ms": dev_ms,
           "tokens_per_s": B * (V + S) / wall * 1e3,
           "max_memory_allocated": peak, "profile": prof,
           "text_slice_loss": loss,
           "card_vs_cpu": {**card_cpu, "vision_tokens": LLAVA_CPU[0],
                           "text_tokens": LLAVA_CPU[1],
                           "tolerance": LLAVA_CPU_TOL}}
    results["prefill_llava_next_34b"] = rec
    emit("path:prefill_llava_next_34b", **rec)
    check(card_cpu["max_abs_logit_diff"] <= LLAVA_CPU_TOL,
          f"prefill_llava_next_34b card vs CPU: max |Δlogit| "
          f"{card_cpu['max_abs_logit_diff']} within {LLAVA_CPU_TOL}")


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist-child", help=argparse.SUPPRESS)
    ap.add_argument("dist_spec", nargs="?", default="",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the GPU and never falls back to the CPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    if args.dist_child:
        return dist_child(args.dist_child, args.seed, args.dist_spec)
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    rng = np.random.default_rng(args.seed)
    results = {}
    results["build"] = phase_build()
    phase_queue_scan(torch, rng, results)
    phase_hash_route(torch, rng, results)
    phase_stack_scan(torch, rng, results)
    phase_tiered_scan(torch, rng, results)
    phase_relaxed_kernel(torch, rng, results)
    phase_ring_commit(torch, rng, results)
    phase_scan_host_split(torch, rng, results)
    phase_scan_back_to_back(torch, results)
    phase_elastic(torch, rng, results)
    phase_elastic_lifo(torch, rng, results)
    phase_elastic_priority(torch, rng, results)
    phase_elastic_relaxed(torch, rng, results)
    phase_priority_many_tiers(torch, rng, results)
    phase_relaxed_priority(torch, rng, results)
    phase_elastic_seap(torch, rng, results)
    phase_seap_card_vs_cpu(torch, rng, results)
    phase_protocol_replay(torch, args.seed, results)
    phase_data_pipeline(torch, results)
    phase_telemetry(torch, rng, results)
    phase_checkpoint_fault(torch, rng, results)
    phase_seed_wave(torch, rng, results)
    phase_workqueue(torch, rng, results)
    phase_sim_runtime(torch, rng, results)
    phase_distributed(torch, args.seed, results)
    phase_wavecheck(torch, results)
    phase_examples(torch, results)
    phase_profile(torch, rng, results)
    phase_scan_device_split(torch, rng, results)
    phase_hash_balance(torch, rng, results)
    phase_flash_attention(torch, results)
    phase_ssd_scan(torch, results)
    zamba = phase_prefill_zamba2(torch, args.seed, results)
    phase_serve_zamba2(torch, rng, results, zamba)
    phase_serve_zamba2(torch, rng, results, zamba, telemetry=True)
    phase_serve_edf_zamba2(torch, rng, results, zamba)
    phase_distributed_serve(torch, args.seed, results)
    phase_flash_attention_bwd(torch, results)
    phase_ssd_scan_bwd(torch, results)
    phase_train_zamba2(torch, results, zamba)
    phase_train_card_vs_cpu(torch, args.seed, results)
    phase_train_loop(torch, results)
    moe = phase_prefill_granite_moe(torch, args.seed, results)
    phase_serve_granite_moe(torch, rng, results, moe)
    phase_train_granite_moe(torch, results, moe)
    del moe
    whisper = phase_prefill_whisper_small(torch, args.seed, results)
    phase_train_whisper_small(torch, results, whisper)
    del whisper
    torch.cuda.empty_cache()
    phase_prefill_llava_next_34b(torch, args.seed, results)
    hb = results["hash_balance"]

    def scan_row(name, n, path, launches, replaces, **extra):
        r = results[(name, n)]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/segscan.cu",
                "replaces": replaces, "path": path,
                "shape": f"n={n} (one wave)", "launches": launches,
                "matched_plain": r["bit_identical"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "device_ms": r["device_ms"],
                "device_kernels": r["device_kernels"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, **extra}
    q24 = results[("queue_scan", TIMED_N[1])]
    def two(path, kernel):
        """A kernel's launches on a two-process path: both processes'."""
        if path == "distributed_serve_edf_zamba2":
            return sum(r["tiered_queue_scan_launches"]
                       for r in results[path]["per_process"])
        return sum(results[path]["launches_by_process"][kernel])
    # the tiered kernel's launches, counted on each path that runs it
    tiered = {
        "elastic_priority": results["elastic_priority"][
            "tiered_scan_launches"],
        "elastic_seap": results["elastic_seap"]["tiered_scan_launches"],
        "serve_edf_zamba2": results["serve_edf_zamba2"]["launches"][
            "tiered_queue_scan"],
        "serve_tiers_zamba2": results["serve_tiers_zamba2"]["launches"][
            "tiered_queue_scan"],
        **{p: two(p, "tiered_queue_scan") for p in (
            "distributed_priority", "distributed_relaxed",
            "distributed_seap", "distributed_serve_edf_zamba2")},
        "wavecheck": results["wavecheck"]["launches"]["tiered_queue_scan"]}
    # the FIFO, stack and hash-route kernels' launches on each path that
    # runs them
    replay = {mode: r["launches"]
              for mode, r in results["protocol_replay"].items()}
    fifo_paths = {
        "elastic_fifo": results["elastic_fifo"]["queue_scan_launches"],
        "workqueue": results["workqueue"]["queue_scan_launches"],
        "sim_runtime": results["sim_runtime"]["queue_scan_launches"],
        "distributed_fifo": two("distributed_fifo", "queue_scan"),
        "protocol_replay": replay["queue"]["queue_scan"],
        "wavecheck": results["wavecheck"]["launches"]["queue_scan"]}
    lifo_paths = {
        "elastic_lifo": results["elastic_lifo"]["stack_scan_launches"],
        "distributed_lifo": two("distributed_lifo", "stack_scan"),
        "protocol_replay": replay["stack"]["stack_scan"],
        "wavecheck": results["wavecheck"]["launches"]["stack_scan"]}
    hash_paths = {
        "hash_balance": hb["hash_route_launches"],
        "relaxed_priority": results["relaxed_priority"][
            "hash_route_launches"],
        "seap_card_vs_cpu": results["seap_card_vs_cpu"][
            "hash_route_launches"],
        "protocol_replay": sum(r["hash_route"] for r in replay.values())}
    relaxed_paths = {
        "elastic_relaxed_priority": results["elastic_relaxed_priority"][
            "relaxed_deletemin_launches"],
        "distributed_relaxed": two("distributed_relaxed",
                                   "relaxed_deletemin"),
        "wavecheck": results["wavecheck"]["launches"]["relaxed_deletemin"]}
    kernels = [
        scan_row("queue_scan", 65_536, ", ".join(fifo_paths),
                 sum(fifo_paths.values()),
                 "src/repro/kernels/segscan/kernel.py:244",
                 launches_by_path=fifo_paths,
                 kernel="queue_scan_lookback, one launch a call",
                 ms_2e24=q24["ms"], device_ms_2e24=q24["device_ms"],
                 bound_ms_2e24=q24["bound_ms"]),
        {"name": "hash_route", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_route.cu",
         "replaces": "src/repro/kernels/hash_route/kernel.py:49",
         "path": ", ".join(hash_paths),
         "shape": f"n={hb['n']}, 6 shards (hash_balance)",
         "launches": sum(hash_paths.values()),
         "launches_by_path": hash_paths,
         "matched_plain": hb["identical"],
         "max_abs_err": hb["max_abs_err"], "ms": hb["ms"],
         "device_ms": hb["device_ms"], "device_kernels": hb["device_kernels"],
         "plain_ms": hb["plain_ms"], "bound_ms": hb["bound_ms"],
         "bound_by": hb["bound_by"], "library_ms": None,
         "by_n": {str(n): {k: r[k] for k in ("ms", "device_ms", "bound_ms")}
                  for n, r in [*results["hash_route_floor"].items(),
                               (16_777_216, results[
                                   ("hash_route", 16_777_216, 64)])]}},
        scan_row("stack_scan", 65_536, ", ".join(lifo_paths),
                 sum(lifo_paths.values()),
                 "src/repro/kernels/segscan/kernel.py:303",
                 launches_by_path=lifo_paths),
        scan_row("tiered_queue_scan", 65_536, ", ".join(tiered),
                 sum(tiered.values()),
                 "src/repro/kernels/segscan/kernel.py:361",
                 launches_by_path=tiered,
                 kernels_per_call=results[("tiered_queue_scan", 65_536)][
                     "kernels_per_call"],
                 launches_300_tiers=results["priority_300_tiers"][
                     "tiered_scan_launches"]),
    ]
    pre = results["prefill_zamba2"]
    train = results["train_zamba2"]["launches"]
    cpu_runs = results["train_card_vs_cpu"]
    loop = results["train_loop"]["launches"]

    def model_row(name, path_launches, replaces, key):
        r = results[name][0]                     # the prefill path's shape
        by_path = {"prefill_zamba2": path_launches, **train_paths(key)}
        if key == "flash_fwd":
            by_path.update(family_paths(key))
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "path": ", ".join(
                    k for k, n in by_path.items() if n),
                "shape": r["case"], "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "matched_plain": True, "max_abs_err": max(
                    c["max_abs_err"] for c in results[name]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], **shapes_of(name)}

    def train_paths(key):
        return {"train_zamba2": train[key],
                "train_card_vs_cpu": sum(cpu_runs[d]["launches"][key]
                                         for d in ("float32", "bfloat16")),
                "train_loop": loop[key]}

    def family_paths(key):
        """A model kernel's launches on the moe, vlm and encdec paths
        (each counted from 0 just before its run)."""
        paths = {"train_granite_moe": results["train_granite_moe"],
                 "train_whisper_small": results["train_whisper_small"]}
        if key == "flash_fwd":
            paths = {"prefill_granite_moe": results["prefill_granite_moe"],
                     "prefill_whisper_small": results[
                         "prefill_whisper_small"],
                     "prefill_llava_next_34b": results[
                         "prefill_llava_next_34b"], **paths}
        return {k: r["launches"][key] for k, r in paths.items()}

    def shapes_of(name):
        """Every shape the kernel's phase held and timed."""
        keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")
        return {"by_shape": {c["case"]: {k: c.get(k) for k in keys}
                             for c in results[name]}}
    fb, sb = results["flash_attention_bwd"][0], results["ssd_scan_bwd"]
    bwd_paths = {**train_paths("flash_bwd"), **family_paths("flash_bwd")}
    kernels += [
        model_row("flash_attention", pre["flash_attention_launches"],
                  "src/repro/kernels/flash_attention/kernel.py:84",
                  "flash_fwd"),
        model_row("ssd_scan", pre["ssd_scan_launches"],
                  "src/repro/kernels/ssd_scan/kernel.py:67", "ssd_fwd"),
    ]
    backward_rows = [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/layers.py:134",
         "replaces_note": "no Pallas backward: the reference differentiates "
                          "its jnp attention (_sdpa_chunked) with "
                          "jax.value_and_grad (repro/train/train_step.py:42)",
         "path": "train_zamba2, train_card_vs_cpu, train_loop, "
                 "train_granite_moe, train_whisper_small",
         "shape": fb["case"], "kernel": fb["kernel"],
         "launches": sum(bwd_paths.values()),
         "launches_by_path": bwd_paths,
         "wgmma_route_launches_by_path": {
             **train_paths("flash_bwd_tc"), **family_paths("flash_bwd_tc")},
         "kernel_launches_profiled": fb["kernel_launches_profiled"],
         "matched_plain": True,
         "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
         "device_ms": fb["device_ms"],
         "device_ms_by_kernel": fb["device_ms_by_kernel"],
         "ptxas": fb["ptxas"], "plain_ms": fb["plain_ms"],
         "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
         "library_ms": fb["library_ms"], "library": fb["library"],
         **shapes_of("flash_attention_bwd")},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/models/ssm.py:46",
         "replaces_note": "no Pallas backward: the reference differentiates "
                          "_ssd_chunked with jax.value_and_grad",
         "path": "train_zamba2", "shape": sb["case"], "kernel": sb["kernel"],
         "launches": train["ssd_bwd"],
         "launches_by_path": train_paths("ssd_bwd"),
         "kernel_launches_profiled": sb["kernel_launches_per_backward"],
         "matched_plain": True, "max_abs_err": max(sb["max_abs_err"].values()),
         "rel_err": sb["rel_err"], "ms": sb["ms"],
         "device_ms": sb["device_ms"],
         "device_ms_by_kernel": sb["device_ms_by_kernel"],
         "plain_ms": sb["plain_ms"],
         "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
         "library_ms": None},
    ]
    cases = {k[1]: r for k, r in results.items()
             if isinstance(k, tuple) and k[0] == "relaxed_deletemin"}
    rel = cases["p4_k1"]
    kernels.append({
        "name": "relaxed_deletemin", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/relaxed.cu",
        "replaces": "src/repro/core/scan_queue.py:294",
        "replaces_note": "the reference's lax.scan (:294-316); no Pallas "
                         "kernel there",
        "path": ", ".join(relaxed_paths),
        "shape": "n=65536 (one wave), P=4, relaxation 1, 64 shards",
        "launches": sum(relaxed_paths.values()),
        "launches_by_path": relaxed_paths,
        "matched_plain": all(r["bit_identical"] for r in cases.values()),
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "ms": rel["ms"], "device_ms": rel.get("device_ms", "not measured"),
        "device_kernels": rel.get("device_kernels", "not measured"),
        "plain_ms": rel["plain_ms"], "bound_ms": rel["bound_ms"],
        "bound_by": rel["bound_by"],
        "chain_steps": rel["chain_steps"],
        "cycles_per_step": rel["cycles_per_step"],
        "library_ms": None,
        "ms_by_case": {k: r["ms"] for k, r in cases.items()},
        "device_ms_by_case": {k: r.get("device_ms", "not measured")
                              for k, r in cases.items()}})
    # the commit kernel's launches, counted from 0 on each path that runs
    # it; its own phase's check and timing launches and the profiled ones
    # apart
    rc = results[("ring_commit", 64)]
    ring_paths = {
        **{p: results[p]["ring_commit_launches"] for p in (
            "elastic_fifo", "elastic_priority", "elastic_relaxed_priority",
            "elastic_seap", "workqueue", "sim_runtime", "wavecheck")},
        "protocol_replay": replay["queue"]["ring_commit"],
        **{p: sum(results[p]["ring_commit_launches_by_process"])
           for p in ("distributed_fifo", "distributed_priority",
                     "distributed_relaxed", "distributed_seap")},
        **{p: results[p]["launches"]["ring_commit"] for p in (
            "serve_zamba2", "serve_edf_zamba2", "serve_tiers_zamba2")},
        "distributed_serve_edf_zamba2": sum(
            r["ring_commit_launches"] for r in results[
                "distributed_serve_edf_zamba2"]["per_process"])}
    kernels.append({
        "name": "ring_commit", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_commit.cu",
        "replaces": "none",
        "replaces_note": "the reference's ring_commit is plain jnp "
                         "(src/repro/dqueue/wave_engine.py:143)",
        "path": ", ".join(ring_paths),
        "shape": "64 shards x 64 x 1,024 rows, W = 4, the pipelined view",
        "launches": sum(ring_paths.values()),
        "launches_by_path": ring_paths,
        "check_and_timing_launches": {
            "kernel:ring_commit": sum(results[("ring_commit", n)]["launches"]
                                      for n in RING_SHARDS),
            "kernel:device_split": sum(
                results[("ring_commit", n)].get("profiled_launches", 0)
                for n in RING_SHARDS)},
        "matched_plain": True,
        "max_abs_err": 0, "ms": rc["ms"],
        "device_ms": rc.get("device_ms", "not measured"),
        "plain_ms": rc["plain_ms"], "bound_ms": rc["bound_ms"],
        "bound_by": rc["bound_by"], "library_ms": None,
        "by_shards": {n: {k: results[("ring_commit", n)].get(k)
                          for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms")} for n in RING_SHARDS}})
    kernels += backward_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
