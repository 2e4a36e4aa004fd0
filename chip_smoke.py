#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit):

  0. device: needs CUDA; prints the card's name and power limit.
  1. build: compiles the CUDA kernels of src/repro_torch/kernels/csrc with
     nvcc (sm_90a) into build/kernels/ and prints the build time: the
     histogram, split gain, forest traversal, flash-attention forward and
     flash-attention backward.
  2. kernels: each kernel's wrapper against its plain torch version on the
     card, at the shapes of the SyD10M9A build and at edge shapes; times the
     kernel, the plain version and the library call.  The histogram also in
     each regime of its plan (every case in one slot, 20% live over 256
     slots compacted, census_pums' shape in one slot and over 256, K = 1,
     N = 1), each timed beside its bound with the plan it took; split gain
     timed by the profiler (its kernel alone).
  3. SyD10M9A at full size (10,000,000 cases, 9 attributes, 256 bins) grown
     with the defaults (the CUDA kernels) and collect_stats=True; both
     kernels must have been launched by that build.  Then one timed build
     each of the defaults and of impl="torch" on the same card, both without
     stats; all three trees must be equal.  Then one traced build
     (impl="cuda", a fresh Tracer and Registry, collect_stats=True): its
     tree must equal theirs, its superstep and splitAtt spans and
     frontier_supersteps_total must be its supersteps, and its histogram
     and split-gain launches those supersteps (with live cases, for the
     histogram).  Prints the time of each phase (splitPre, splitAtt,
     splitPost, each ending in a wait for the card) beside the untraced
     wall time and the text report, and writes the Chrome trace to
     build/trace_syd10m9a.json.
  4. census_pums at scale 1.0 (299,285 cases, 40 attributes): the wide
     discrete-split case, impl="cuda" against impl="torch".
  5. forest: a 16-tree random forest on SyD10M9A trained by
     ensemble.train_forest (seed 0, bootstrap, mtry 3, impl="frontier" on
     the CUDA kernels, 4 farm workers); the trees must be members 0..15
     with no quarantine, members 0, 7 and 15 must equal train_tree grown
     alone, and the histogram and split-gain launches of the training run
     must equal its supersteps (with live cases, for the histogram).  Its
     OOB score through the traversal kernel (one launch) must be finite,
     cover 1 - (1 - 1/e)^16 of the cases and equal the plain traversal's.
     Then the forest packed on the card at M = 2^18; the traversal kernel
     against its plain version at the full shape (T = 16, N = 10M) with and
     without unknowns, at edge shapes (N = 1, 257, 1024, a lone leaf, a
     census_pums forest with and without unknowns, 70,000 small trees) and
     against the per-tree oracle on a slice; times the kernel alone in each
     regime of its plan (N = 10M, the serving batch N = 1,024, census_pums,
     the 70,000 trees; CUDA events around launches queued behind a spin of
     the card) beside its bound and prints the plan taken; times
     the plain version and predict() end to end (one launch).
  6. serving: the trained forest published by ensemble.publish_forest to a
     registry under build/ (its manifest must carry the phase-5 OOB score,
     the tree ids and no quarantine), opened by a ModelHandle on the card
     and served as 65,536 single-row requests by a BatchPredictService over
     4 replicas (policy ws, max_batch 1024); every label must equal one
     batched predict of the same rows, the traversal kernel must have
     served every batch, and the published arrays' crc32 must equal the
     trained trees packed in memory.
  7. flash attention: the flash kernels (bf16: the tensor-core wgmma/TMA
     kernel, f32: the scalar one) against their plain version on the card
     at the six FLASH_CASES of the JAX package's tests, at D = 128 and 256
     with ragged S (1, 63, 65, 1000), at B = 2 with ragged S (63, 129,
     1,000) and D = 64, 128, 256 in bf16, and at full gemma2_9b layer
     shapes (B = 1, S = 7,000, H = 16, KV = 8, D = 256; window 4,096 and 0,
     softcap 50) in bf16 and f32; times the bf16 kernel and the plain
     version at the three gemma2 layer settings, beside the earlier scalar
     bf16 kernel's times (quoted from PERF.md, not re-run), and torch's
     scaled_dot_product_attention (the library yardstick, never called by
     the port) at S = 7,000 with window 0 and softcap 0.  Then the backward
     kernel (csrc/flash_attention_bwd.cu) against the plain backward, in
     f32 and bf16, at the JAX test shapes, at ragged S (1, 63, 65, 1000)
     with D = 128 and 256, and at the training layer shapes (S = 4,096):
     gemma2_9b's (B 1, H 16, KV 8, D 256, softcap 50, window 4,096 and 0),
     gemma3_4b's (B 2, H 8, KV 4, D 256, window 1,024 and 0) and
     phi4_mini's (B 2, H 24, KV 8, D 128); at each, the forward kernel's
     output must not change when it also writes the LSE, and its LSE must
     equal the plain version's.  Times the bf16 backward kernel and the
     plain backward at the layer shapes, and torch autograd through causal
     GQA scaled_dot_product_attention (the yardstick) at window 0, softcap
     0, each beside its bound.
  8. LM serving: gemma2_9b at full width and depth (42 layers, 10.16B
     parameters, bf16, random weights from seed 0) through
     repro_torch.launch.serve's engine: one replica, 4 slots, max_seq
     8,192, policy ws, greedy, 32 new tokens for each of 8 prompts of
     7,000 / 5,121 / 4,096 / 3,000 / 1,537 / 777 / 256 / 33 tokens.  All 8
     must complete with 32 tokens and no failure, through exactly 42 x 8
     flash launches, all of the bf16 tensor-core kernel; each first token
     must equal the argmax of a separate prefill of its prompt, and the
     7,000-token prefill's logits with the kernel must agree with those
     through the plain attention.

  9. the oracle and the farm under chaos, on census_pums cut to scale 0.1
     (29,928 cases, 40 attributes, 128 bins; on the full set the oracle
     alone would outlast the phase's budget, see CHAOS_SCALE): c45.build on the card must equal the impl="cuda"
     frontier tree of the same data; frontier.build_farm on 4 workers
     under crash_p 0.2 with worker 1 dead must equal it, with retries, no
     quarantine and no failure but the injected ones; and train_forest of
     8 trees under the same chaos must equal train_forest_sequential.
     Prints each build's wall time.  It runs after the LM has freed the
     card, and records the c45 build's task trace for phase 10.
 10. the paper's farm, simulated and measured, on census_pums cut to scale
     0.02 (5,985 cases, 40 attributes, 128 bins): c45.build on the card,
     timed, records its task trace; frontier.build_farm on 1, 2 and 4
     workers without faults must equal it.  The farm simulator
     (repro_torch.core.simulate), calibrated on c45's seconds, replays the
     trace under NP and NAP with the drr, od and ws policies at 1, 2, 4
     and 8 workers; also NP and NAP under ws with a fixed cost a task
     (c45's seconds over its nodes: the card's c45 is bound by launches),
     and NP and NAP under ws at 8 workers on phase 9's trace.  Gates are
     the model's invariants: no speedup above its workers + 0.05, the
     calibrated sequential time equal to c45's seconds (rel 1e-9), and
     with no overheads, NP's worker busy time summing to it (rel 1e-6).
     Prints {"farm_model": {...}}: the simulated speedups beside the
     measured farm's (c45 seconds over farm seconds).

 11. LM training: gemma3_4b at full width and depth (34 layers, 4.55B
     parameters in bf16, random weights from seed 0) through
     repro_torch.launch.train.train(reduced=False, steps=8, global_batch=2,
     seq_len=4,096), after phase 8 has freed the card.  First one
     loss-and-gradient evaluation on the first batch and the same weights
     with impl="cuda" against impl="torch" (the plain attention pair): the
     loss, the global grad norm and the relative L2 of the gradients of the
     embedding, layer 0's wq and the last global layer's w_down must agree.
     Then the run: every loss finite and the last below the first; the
     forward kernel launched 64 times a step (the 30 layers of the 5
     rematerialised cycles twice, the 4 tail layers once) and the backward
     kernel 34 times, all bf16.  Prints each step's wall time and tokens/s
     and the peak memory.
 11b. resume on the card: reduced gemma3_4b at 256 tokens, 4 steps straight
     against 2 steps, a checkpoint (which must verify) and a resume for 2
     more; the last losses must be equal, bit for bit.

Before the kernels' JSON record come {"farm_model": {...}}, {"train":
{...}} and {"ensemble": {...}} (trees/s, the OOB score, coverage and time
split, the chaos phase's failures and wall times); the last line is {"ok":
true, "device": {...}}.  It imports
nothing of JAX or of the JAX package: the data generators and the grow
configuration (repro_torch.configs.yadt.WORKLOAD.grow) are the port's.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# SyD10M9A (paper Table 1): 10M cases, 256 bins; every build grows with
# repro_torch.configs.yadt.WORKLOAD.grow (2^18 nodes, 256 slots).
SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
CENSUS_SCALE = 1.0
CENSUS_BINS = 128
# The forest of phases 5 and 6: the ForestConfig defaults (seed 0,
# bootstrap, mtry = ceil(sqrt(A))) at 16 trees, trained by the farm's 4
# workers; members grown alone against it; 4 trees on census_pums.
FOREST_TREES = 16
FOREST_SEED = 0
FOREST_WORKERS = 4
FOREST_ALONE = (0, 7, 15)
CENSUS_FOREST_TREES = 4
# A case is out of bag for a tree with chance (1 - 1/N)^N ~ 1/e, so 16
# trees cover 1 - (1 - 1/e)^16 of the cases; N = 10M puts the share within
# a few 1e-6 of it.
OOB_COVERAGE_TOL = 1e-4
UNKNOWN_SHARE = 0.05
SERVE_REQUESTS = 65_536
SERVE_REPLICAS = 4
SERVE_MAX_BATCH = 1024

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory, and the
# CUDA cores' f32 rate, used for every scalar operation outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# and the tensor cores' dense bf16 rate, the flash kernel's operations bound
BF16_TENSOR_OPS_PER_S = 989e12

# Phase 7: the JAX package's FLASH_CASES (tests/test_kernels.py:113-121),
# (B, S, H, KV, D, window, softcap, dtype), then gemma2's and yi's head dims
# at ragged lengths, then gemma2_9b's layer shapes at S = 7,000.
FLASH_CASES = [
    (2, 24, 4, 2, 16, 0, 0.0, "float32"),
    (1, 33, 4, 4, 8, 0, 0.0, "float32"),
    (2, 24, 4, 2, 16, 7, 0.0, "float32"),
    (2, 24, 4, 2, 16, 0, 30.0, "float32"),
    (2, 40, 6, 2, 32, 9, 50.0, "float32"),
    (2, 32, 4, 2, 16, 0, 0.0, "bfloat16"),
] + [(1, s, 16, 8, d, w, 50.0, dt) for d in (128, 256)
     for s in (1, 63, 65, 1000) for w in (0, 100)
     for dt in ("float32", "bfloat16")] + [
    # the tensor map's batch edge (B = 2, ragged S) at one to four 64-column
    # boxes, with and without window and softcap
    (2, s, 16, 8, d, w, cap, "bfloat16") for d in (64, 128, 256)
    for s in (63, 129, 1000) for w, cap in ((0, 0.0), (100, 50.0))]
FLASH_S = 7_000
GEMMA_LAYER = dict(H=16, KV=8, D=256)
FLASH_FULL = [(1, FLASH_S, 16, 8, 256, w, 50.0, dt)
              for w in (4096, 0) for dt in ("bfloat16", "float32")]
# The earlier scalar bf16 kernel's times at the three gemma2 layer settings
# (window, softcap), as PERF.md records them: printed beside the
# tensor-core kernel's, not re-run.
FLASH_SCALAR_MS = {(0, 0.0): 21.616, (0, 50.0): 22.59, (4096, 50.0): 18.16}
# Kernel against plain: f32 differs by summation order only (the plain
# version's matmuls run in full f32: TF32 off); bf16 by one rounding step of
# an output near 1 (the tensor-core kernel also rounds P to bf16).
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}

# Phase 7, the backward kernel (csrc/flash_attention_bwd.cu) against the
# plain backward, (B, S, H, KV, D, window, softcap), each in f32 and bf16:
# the JAX test shapes of phase 7, ragged S at D = 128 and 256, then the
# layer shapes of gemma2_9b, gemma3_4b (global and local) and phi4_mini at
# the training length.
BWD_CASES = [c[:7] for c in FLASH_CASES[:6]] + [
    (1, s, 16, 8, d, w, cap) for d in (128, 256) for s in (1, 63, 65, 1000)
    for w, cap in ((0, 0.0), (100, 50.0))]
TRAIN_S = 4_096
BWD_LAYERS = {
    "gemma2_9b_window": (1, TRAIN_S, 16, 8, 256, 4096, 50.0),
    "gemma2_9b_global": (1, TRAIN_S, 16, 8, 256, 0, 50.0),
    "gemma3_4b_global": (2, TRAIN_S, 8, 4, 256, 0, 0.0),
    "gemma3_4b_local": (2, TRAIN_S, 8, 4, 256, 1024, 0.0),
    "phi4_mini": (2, TRAIN_S, 24, 8, 128, 0, 0.0),
}
# Backward kernel against plain: f32 atol 2e-4 (another summation order;
# this script measured at most 3.9e-5 on an H100); bf16 within 1% of the
# largest plain gradient (both round f32 sums to bf16, a relative step of
# 2^-8; measured at most 0.0625 absolute).  The forward's LSE: atol 1e-4
# (measured 2.1e-5: the tensor-core kernel's log2-unit max times ln 2).
BWD_F32_ATOL = 2e-4
BWD_BF16_REL = 1e-2
LSE_ATOL = 1e-4

# Phase 8: gemma2_9b serving at full width and depth.
LM_ARCH = "gemma2_9b"
LM_SEED = 0
LM_SLOTS = 4
LM_MAX_SEQ = 8_192
LM_MAX_NEW = 32
LM_PROMPTS = (7_000, 5_121, 4_096, 3_000, 1_537, 777, 256, 33)
# Last-position logits of the 7,000-token prompt, kernel against plain
# attention, through 42 bf16 layers (logits lie in (-30, 30): softcap).
# The two attentions round their bf16 outputs apart and every later layer
# carries the difference; measured on an H100: relative L2 error of the
# logit vector 0.0196, largest difference 0.094.  Limits about 2.5x that.
LM_LOGIT_REL_TOL = 0.05
LM_LOGIT_ABS_TOL = 0.25

# Phase 11: gemma3_4b trained at full width and depth (34 layers, 4.55B
# parameters in bf16, random weights from seed 0) through launch.train:
# train_4k's sequence length, its global batch of 256 (a pod's) cut to 2 by
# one card's memory (12 bytes a parameter of state, 54.6 GB, plus the
# activations).  A step runs the forward kernel twice for each of the 30
# layers of the five rematerialised cycles and once for each of the 4 tail
# layers, and the backward kernel once a layer.
TRAIN_ARCH = "gemma3_4b"
TRAIN_STEPS = 8
TRAIN_BATCH = 2
TRAIN_SEED = 0
# One loss-and-gradient evaluation on the first batch, the kernel pair
# against the plain pair: the bf16 forward kernel rounds P to bf16 before
# P . V, and 34 layers carry the difference.  Measured on an H100: loss
# |diff| 1.5e-4 (of 12.74), grad norm relative 5.2e-5, gradient relative
# L2 0.0033 (embedding), 0.0048 (layer 0's wq), 0.0029 (layer 29's
# w_down).  Limits about 3x that.
TRAIN_LOSS_ATOL = 5e-4
TRAIN_GRAD_REL_L2 = 0.015
TRAIN_GNORM_REL = 2e-4
# Phase 11b: resume on the card, reduced gemma3_4b at 256 tokens.
RESUME_SEQ = 256

# Phase 9: the c45 oracle and the farm under chaos on census_pums, cut to
# CHAOS_SCALE of its 299,285 cases (29,928): on the full set the oracle
# alone takes longer than the 90 s this phase gives it, and the farm build
# under chaos a few times the oracle (PERF.md section 4, measured by
# repro_torch.profile_train).  The injector's schedule and the farm's
# retry policy are the JAX package's chaos tests' (crash_p 0.2, worker 1
# dead, up to 8 retries).
CHAOS_SCALE = 0.1
CHAOS_WORKERS = 4
CHAOS_FOREST_TREES = 8
CHAOS_SEED = 7
CHAOS_FAULT = dict(max_retries=8, seed=3, backoff_base=1e-4)

# Phase 10: the paper's farm on census_pums cut to FARM_SCALE (5,985
# cases): c45 on the card takes about 3 s there and the farm build 1.4-4.8
# times that (PERF.md section 6), so the phase fits in about 30 s.  The
# simulator replays at the paper's worker counts; its speedups may not pass
# the workers by more than SPEEDUP_SLACK (the tests' bound on the model).
FARM_SCALE = 0.02
FARM_WORKERS = (1, 2, 4)
SIM_WORKERS = (1, 2, 4, 8)
SIM_POLICIES = ("drr", "od", "ws")
SPEEDUP_SLACK = 0.05

# Split-gain score tolerance: the discrete branch sums per-bin entropy terms
# in another order than the torch reduction (f32 rounding, about 1 ulp of
# values below 6 bits); bins and the -inf pattern must match exactly.
SCORE_ATOL = 1e-5
SCORE_RTOL = 1e-5


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _timed(fn):
    """(fn(), its wall seconds), the card waited for on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernel_ms(fn, key: str, reps: int) -> float:
    """Mean device time of the kernels named ``key`` in one call of ``fn``
    (torch.profiler, device activity only): the kernel alone, where CUDA
    events around back-to-back calls of a small kernel time the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key
               ) / 1e3 / reps


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def _hist_inputs(gen, n, a, b, c, k, *, live, unknown, integral, dev):
    import torch
    x = torch.randint(0, b, (n, a), generator=gen, device=dev,
                      dtype=torch.int32)
    x[torch.rand((n, a), generator=gen, device=dev) < unknown] = -1
    y = torch.randint(0, c, (n,), generator=gen, device=dev,
                      dtype=torch.int32)
    if integral:
        w = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
    else:
        w = torch.rand((n,), generator=gen, device=dev) * 2
    slot = torch.randint(0, k, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    slot[torch.rand((n,), generator=gen, device=dev) >= live] = -1
    return x, y, w, slot


def check_histogram(ds_x, ds_y, ds_w, n_bins, n_classes, k, gen, dev):
    """Histogram kernel vs its plain version, in every regime of its plan.
    Returns (record, inputs for the split-gain check)."""
    import torch
    from repro_torch.kernels import autotune, compaction, histogram, ref
    kw = dict(n_slots=k, n_bins=n_bins, n_classes=n_classes)
    n, a_dim = ds_x.shape

    # the main path's root superstep: every case live in slot 0 (SyD's
    # discrete columns have 5, 9 and 20 values), with and without the
    # build's live-slot hint
    root_slot = torch.zeros((n,), dtype=torch.int32, device=dev)
    want = ref.frontier_histogram_ref(ds_x, ds_y, ds_w, root_slot, **kw)
    for hint in (1, None):
        got = histogram.frontier_histogram(ds_x, ds_y, ds_w, root_slot,
                                           n_live_slots=hint, **kw)
        check(torch.equal(got, want),
              f"histogram != plain at the root shape (hint {hint})")
    max_err = 0.0

    # a deep superstep: 20% of the cases live over all K slots, gathered by
    # the compaction path as the build does
    live_slot = torch.randint(0, k, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
    live_slot[torch.rand((n,), generator=gen, device=dev) >= 0.2] = -1
    live = compaction.live_cases(ds_x, ds_y, ds_w, live_slot)
    got = histogram.frontier_histogram(*live, n_live_slots=k, **kw)
    sub_hist = ref.frontier_histogram_ref(ds_x, ds_y, ds_w, live_slot, **kw)
    check(torch.equal(got, sub_hist), "compacted histogram != plain")

    # edge shapes: unknown bins, slot -1, B off any tile, C = 23, wide A;
    # each under the planner's choice and both plans pinned
    edges = [(100_003, 5, 13, 23, 37), (50_000, 40, 128, 2, 256),
             (4_099, 3, 300, 3, 5), (1, 2, 1, 2, 1)]
    for (en, ea, eb, ec, ek) in edges:
        for integral in (True, False):
            x, y, w, s = _hist_inputs(gen, en, ea, eb, ec, ek, live=0.8,
                                      unknown=0.1, integral=integral,
                                      dev=dev)
            ekw = dict(n_slots=ek, n_bins=eb, n_classes=ec)
            want = ref.frontier_histogram_ref(x, y, w, s, **ekw)
            for pin in ({}, dict(block_k=0), dict(block_k=1)):
                got = histogram.frontier_histogram(x, y, w, s, **ekw, **pin)
                if integral:
                    check(torch.equal(got, want), f"histogram != plain at "
                          f"{(en, ea, eb, ec, ek)} {pin}")
                else:
                    # non-integral weights: atomics add in no fixed order
                    check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
                          f"histogram !~ plain at {(en, ea, eb, ec, ek)} "
                          f"{pin}")
                    max_err = max(max_err, (got - want).abs().max().item())

    # the regimes of the plan, each against the plain version, its kernel
    # timed (profiler) beside its bound: (name, inputs, K, live-slot hint)
    census = _hist_inputs(gen, 299_285, 40, 128, 2, 256, live=1.0,
                          unknown=0.0, integral=True, dev=dev)
    census_root = torch.zeros_like(census[3])
    m = 1_000_000
    regimes = [
        ("root: all N in slot 0", (ds_x, ds_y, ds_w, root_slot), k, 1),
        ("20% live over 256 slots, compacted", live, k, k),
        ("census A=40 B=128: all in slot 0",
         (*census[:3], census_root), 256, 1),
        ("census A=40 B=128: over 256 slots", census, 256, 256),
        ("K=1: 1M cases", (ds_x[:m], ds_y[:m], ds_w[:m], root_slot[:m]),
         1, 1),
        ("n=1", (ds_x[:1], ds_y[:1], ds_w[:1], root_slot[:1]), k, 1),
    ]
    timed = []
    for name, (x, y, w, s), rk, hint in regimes:
        b = 128 if x.shape[1] == 40 else n_bins
        rkw = dict(n_slots=rk, n_bins=b, n_classes=n_classes)
        got = histogram.frontier_histogram(x, y, w, s, n_live_slots=hint,
                                           **rkw)
        check(torch.equal(got, ref.frontier_histogram_ref(x, y, w, s, **rkw)),
              f"histogram != plain in regime {name!r}")
        plan = autotune.plan_histogram(
            n_cases=x.shape[0], n_attrs=x.shape[1], n_live_slots=hint, **rkw)
        r_ms = kernel_ms(lambda: histogram.frontier_histogram(
            x, y, w, s, n_live_slots=hint, **rkw),
                         "frontier_histogram_kernel", reps=10)
        # the kernel's own work: each case row (A bins, label, weight,
        # slot) read once, each non-zero cell written once
        r_bound, r_by = bound(x.shape[0] * (4 * x.shape[1] + 12)
                              + int(torch.count_nonzero(got)) * 4,
                              x.shape[0] * x.shape[1])
        timed.append(dict(regime=name, N=x.shape[0], A=x.shape[1], K=rk,
                          plan=plan.mode,
                          ms=r_ms, bound_ms=r_bound, bound_by=r_by))
        print(f"histogram regime {name}: N={x.shape[0]} A={x.shape[1]} "
              f"K={rk} plan {plan.mode}: {r_ms:.4f} ms (bound "
              f"{r_bound:.5f} by {r_by}, {r_ms / r_bound:.1f}x)")
    del census, census_root

    # the record: the root shape (10M live cases), the wrapper with its
    # zero fill, the plain version and index_add_ on the same inputs
    ms = cuda_ms(lambda: histogram.frontier_histogram(
        ds_x, ds_y, ds_w, root_slot, n_live_slots=1, **kw), reps=10)
    plain_ms = cuda_ms(lambda: ref.frontier_histogram_ref(
        ds_x, ds_y, ds_w, root_slot, **kw), reps=3)
    flat, w_flat = ref.histogram_scatter(ds_x, ds_y, ds_w, root_slot, **kw)
    lib_out = torch.zeros(((k + 1) * a_dim * (n_bins + 1) * n_classes,),
                          device=dev)
    library_ms = cuda_ms(lambda: lib_out.index_add_(0, flat, w_flat), reps=3)
    del flat, w_flat, lib_out
    out_bytes = k * a_dim * (n_bins + 1) * n_classes * 4
    bound_ms, bound_by = bound(n * (4 * a_dim + 12) + out_bytes, n * a_dim)
    print(f"histogram: root N={n} {ms:.4f} ms with the zero fill (plain "
          f"{plain_ms:.4f}, index_add_ {library_ms:.4f}, bound {bound_ms:.4f}"
          f" by {bound_by})")
    record = dict(
        name="frontier_histogram", route="cuda",
        source="src/repro_torch/kernels/csrc/histogram.cu",
        replaces="src/repro/kernels/histogram.py:101",
        jax="repro.kernels.histogram.frontier_histogram",
        max_abs_err=max_err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=dict(N=n, A=a_dim, B1=n_bins + 1, C=n_classes, K=k),
        regimes=timed)
    return record, sub_hist


def _gain_case(hist, tw, cont, nb, min_objs, criterion):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_gain as sg
    s_k, b_k = sg.split_gain(hist, tw, cont, nb, min_objs=min_objs,
                             criterion=criterion)
    s_r, b_r = ref.split_gain_ref(hist, tw, cont, nb, min_objs=min_objs,
                                  criterion=criterion)
    check(torch.equal(b_k, b_r), f"split_bin != plain ({criterion})")
    fin = torch.isfinite(s_r)
    check(torch.equal(fin, torch.isfinite(s_k)),
          f"score -inf pattern != plain ({criterion})")
    check(torch.allclose(s_k[fin], s_r[fin], rtol=SCORE_RTOL,
                         atol=SCORE_ATOL), f"score !~ plain ({criterion})")
    return (s_k[fin] - s_r[fin]).abs().max().item() if fin.any() else 0.0


def check_split_gain(sub_hist, cont, nb, n_bins, gen, dev):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_gain as sg
    hist = sub_hist[:, :, :n_bins, :]        # the build's strided view
    tw = sub_hist[:, 0].sum((1, 2))          # node weight incl. unknowns
    max_err = 0.0
    for crit in ("gain", "gain_ratio"):
        max_err = max(max_err, _gain_case(hist, tw, cont, nb, 2.0, crit))
    # edge shapes: integral counts, non-empty padding bins, C = 23, B off
    # the block size, discrete attributes, total_w above the known weight
    for (k, a, b, c) in [(16, 6, 13, 23), (7, 5, 300, 3), (32, 9, 256, 2),
                         (3, 4, 1, 2), (256, 40, 128, 2), (1, 9, 256, 2)]:
        h = torch.randint(0, 6, (k, a, b, c), generator=gen, device=dev
                          ).float()
        h[torch.rand((k, a, b, c), generator=gen, device=dev) < 0.3] = 0
        e_tw = h.sum((1, 2, 3)) / a + torch.randint(
            0, 5, (k,), generator=gen, device=dev).float()
        e_cont = torch.rand((a,), generator=gen, device=dev) < 0.5
        e_nb = torch.randint(1, b + 1, (a,), generator=gen, device=dev,
                             dtype=torch.int32)
        for crit in ("gain", "gain_ratio"):
            for min_objs in (2.0, 0.0):
                max_err = max(max_err, _gain_case(h, e_tw, e_cont, e_nb,
                                                  min_objs, crit))
    k, a_dim, _, c = hist.shape
    ms = kernel_ms(lambda: sg.split_gain(hist, tw, cont, nb), "split_gain",
                   reps=50)
    call_ms = cuda_ms(lambda: sg.split_gain(hist, tw, cont, nb), reps=50)
    plain_ms = cuda_ms(lambda: ref.split_gain_ref(hist, tw, cont, nb),
                       reps=10)
    n_ops = k * a_dim * n_bins * (6 * c + 20)
    bound_ms, bound_by = bound(
        k * a_dim * n_bins * c * 4 + k * 4 + a_dim * 5 + k * a_dim * 8, n_ops)
    print(f"split_gain: K={k} A={a_dim} B={n_bins} C={c} {ms:.4f} ms of "
          f"device time (profiler; {call_ms:.4f} ms a call back to back, "
          f"CUDA events), plain {plain_ms:.4f}, bound {bound_ms:.6f} by "
          f"{bound_by}")
    return dict(
        name="split_gain", route="cuda",
        source="src/repro_torch/kernels/csrc/split_gain.cu",
        replaces="src/repro/kernels/split_gain.py:77",
        jax="repro.kernels.split_gain.split_gain",
        max_abs_err=max_err, ms=ms, kernel_ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=dict(K=k, A=a_dim, B=n_bins, C=c))


# --------------------------------------------------------------------------
# phases 3 and 4: the main path
# --------------------------------------------------------------------------

def _timed_build(ds, cfg, **kw):
    import torch
    from repro_torch.core import frontier
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = frontier.build(ds, cfg, **kw)
    torch.cuda.synchronize()
    return tree, time.perf_counter() - t0


def grow_both(name, ds, cfg, dev) -> tuple[dict, object, dict]:
    """Grow with the defaults (CUDA kernels) and with impl="torch" on the
    card; the trees must be equal.  Returns the launch counts of the first
    build (the main path's run), its tree and what was measured."""
    import numpy as np
    from repro_torch.core import frontier
    from repro_torch.core.tree import predict, trees_equal
    from repro_torch.kernels import histogram, split_gain

    histogram.LAUNCHES = split_gain.LAUNCHES = 0
    tree, stats = frontier.build(ds, cfg, collect_stats=True)
    launches = dict(frontier_histogram=histogram.LAUNCHES,
                    split_gain=split_gain.LAUNCHES)
    live_steps = sum(1 for r in stats if r["n_active"] > 0)
    check(launches["frontier_histogram"] > 0 and launches["split_gain"] > 0,
          f"{name}: a kernel was not launched by the build: {launches}")
    check(launches["frontier_histogram"] >= live_steps,
          f"{name}: {launches['frontier_histogram']} histogram launches for "
          f"{live_steps} supersteps with live cases")
    check(tree.size <= cfg.max_nodes and tree.size >= 1, f"{name}: bad size")

    t0 = time.perf_counter()
    pred = predict(tree, ds.x, ds.attr_is_cont)
    acc = (pred.cpu().numpy() == ds.y).mean()
    t_pred = time.perf_counter() - t0
    check(np.isfinite(tree.node_freq[:tree.size].cpu().numpy()).all(),
          f"{name}: non-finite node frequencies")

    # wall times: both implementations built as a user calls them, without
    # collect_stats (whose rows cost host syncs every superstep)
    tree_c, t_cuda = _timed_build(ds, cfg)
    tree_t, t_torch = _timed_build(ds, cfg, impl="torch", device=dev)
    check(trees_equal(tree, tree_c), f"{name}: the stats build's tree != "
          f"the plain build's tree")
    check(trees_equal(tree, tree_t), f"{name}: impl='cuda' tree != "
          f"impl='torch' tree ({tree.size} vs {tree_t.size} nodes)")
    info = dict(dataset=name, cases=ds.n_cases, attrs=ds.n_attrs,
                nodes=tree.size, depth=tree.depth, leaves=tree.n_leaves,
                supersteps=len(stats), live_supersteps=live_steps,
                overflow=bool(stats[-1]["overflow"]) if stats else False,
                build_cuda_s=t_cuda, build_torch_s=t_torch,
                predict_s=t_pred, train_accuracy=float(acc),
                trees_equal=True, launches=launches)
    print(json.dumps(info))
    return launches, tree, info


PHASES = ("splitPre", "splitAtt", "splitPost")


def traced_build(name, ds, cfg, tree, info) -> dict:
    """Phase 3's traced build: frontier.build(impl="cuda") with a fresh
    Tracer and Registry and collect_stats=True.  Its tree must equal
    ``tree`` (which ``grow_both`` held to its other builds), its spans
    and ``frontier_supersteps_total`` its supersteps, and its kernel
    launches those supersteps.  Prints each phase's time beside the
    untraced build's wall time and the text report; writes the Chrome
    trace under build/."""
    from repro_torch.core import frontier
    from repro_torch.core.tree import trees_equal
    from repro_torch.kernels import histogram, split_gain
    from repro_torch.obs import Registry, Tracer, report

    tr, reg = Tracer(), Registry()
    histogram.LAUNCHES = split_gain.LAUNCHES = 0
    (traced, rows), wall = _timed(lambda: frontier.build(
        ds, cfg, impl="cuda", collect_stats=True, tracer=tr, metrics=reg))
    launches = dict(frontier_histogram=histogram.LAUNCHES,
                    split_gain=split_gain.LAUNCHES)
    check(trees_equal(traced, tree), f"{name}: the traced build's tree != "
          f"the untraced builds' tree")
    steps = len(rows)
    check(steps == info["supersteps"], f"{name}: the traced build took "
          f"{steps} supersteps, the untraced {info['supersteps']}")
    summ = tr.span_summary()
    for span in ("superstep", *PHASES):
        check(summ[span]["count"] == steps, f"{name}: {summ[span]['count']}"
              f" {span} spans for {steps} supersteps")
    counted = reg.snapshot()["frontier_supersteps_total"]["series"][0][
        "value"]
    check(counted == steps, f"{name}: frontier_supersteps_total {counted} "
          f"for {steps} supersteps")
    live = sum(1 for r in rows if r["n_active"] > 0)
    check(launches == dict(frontier_histogram=live, split_gain=steps),
          f"{name}: traced build launches {launches} != its {steps} "
          f"supersteps ({live} with live cases)")
    path = ROOT / "build" / f"trace_{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tr.save(str(path))
    phases = {p: summ[p]["total_us"] / 1e6 for p in PHASES}
    out = dict(dataset=name, supersteps=steps, traced_wall_s=wall,
               untraced_wall_s=info["build_cuda_s"],
               superstep_spans_s=summ["superstep"]["total_us"] / 1e6,
               phase_s=phases, launches=launches, trees_equal=True,
               chrome_trace=str(path.relative_to(ROOT)))
    print(report.render(tracer=tr, metrics=reg))
    print(f"{name} traced: {wall:.3f} s against {info['build_cuda_s']:.3f}"
          f" s untraced; " + ", ".join(f"{p} {t:.3f} s"
                                       for p, t in phases.items()))
    print(json.dumps({"traced_build": out}))
    return out


# --------------------------------------------------------------------------
# phase 5: the packed forest and the traversal kernel
# --------------------------------------------------------------------------

def _with_unknowns(x, gen):
    import torch
    x = x.clone()
    x[torch.rand(x.shape, generator=gen, device=x.device)
      < UNKNOWN_SHARE] = -1
    return x


def _infer_case(tab, depth, x, cont, what: str) -> None:
    """Kernel labels == plain labels, exactly."""
    import torch
    from repro_torch.kernels import ref, tree_infer
    got = tree_infer.forest_predict(tab, x, cont, max_depth=depth)
    want = ref.forest_predict_ref(tab, x, cont, max_depth=depth)
    check(got.shape == (tab.shape[0], x.shape[0])
          and got.dtype == torch.int32,
          f"forest_predict: bad output {tuple(got.shape)} {got.dtype} "
          f"({what})")
    check(torch.equal(got, want), f"forest_predict != plain ({what}): "
          f"{int((got != want).sum())} labels differ")


class SuperstepCount:
    """Counts frontier supersteps, and those with live cases (the ones
    whose histogram launches), from every thread while installed: wraps
    ``frontier.superstep``, which ``frontier.build`` looks up each step."""

    def __init__(self):
        import threading
        self.steps = 0
        self._live: list = []
        self._lock = threading.Lock()

    def __enter__(self):
        from repro_torch.core import frontier
        self._inner = inner = frontier.superstep

        def counted(*args, **kw):
            state, stats = inner(*args, **kw)
            with self._lock:
                self.steps += 1
                self._live.append(stats["n_active"] > 0)   # no wait here
            return state, stats
        frontier.superstep = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import frontier
        frontier.superstep = self._inner

    @property
    def live(self) -> int:
        import torch
        return int(torch.stack(self._live).sum()) if self._live else 0


def train_syd_forest(syd, cfg, dev):
    """Phase 5's forest through the trainer: ``train_forest`` on the
    farm's workers with the CUDA kernels; members grown alone must equal
    it, and the kernels' launches must be its supersteps'.  Returns
    (TrainResult, ForestConfig, info)."""
    import torch
    from repro_torch.core.tree import trees_equal
    from repro_torch.ensemble import trainer
    from repro_torch.kernels import histogram, split_gain

    fc = trainer.ForestConfig(n_trees=FOREST_TREES, seed=FOREST_SEED,
                              grow=cfg)
    with SuperstepCount() as steps:
        histogram.LAUNCHES = split_gain.LAUNCHES = 0
        (result, train_s) = _timed(lambda: trainer.train_forest(
            syd, fc, impl="frontier", n_workers=FOREST_WORKERS, device=dev))
        launches = dict(frontier_histogram=histogram.LAUNCHES,
                        split_gain=split_gain.LAUNCHES)
    check(result.tree_ids == list(range(FOREST_TREES))
          and not result.quarantined,
          f"trained trees {result.tree_ids}, quarantined "
          f"{result.quarantined}")
    check(launches == dict(frontier_histogram=steps.live,
                           split_gain=steps.steps),
          f"training launches {launches} != its {steps.steps} supersteps "
          f"({steps.live} with live cases)")
    alone_s = {}
    for tid in FOREST_ALONE:
        alone, alone_s[tid] = _timed(lambda: trainer.train_tree(
            syd, fc, tid, impl="frontier", device=dev))
        check(trees_equal(result.trees[tid], alone),
              f"forest member {tid} != its build alone")
    stats = result.stats
    info = dict(trees=FOREST_TREES, workers=FOREST_WORKERS,
                train_s=train_s, trees_per_s=FOREST_TREES / train_s,
                farm_wall_s=stats["wall_s"],
                worker_tasks=stats["worker_tasks"],
                worker_busy_s=stats["worker_busy"],
                supersteps=steps.steps, live_supersteps=steps.live,
                launches=launches,
                alone_s={str(k): v for k, v in alone_s.items()},
                tree_nodes=[t.size for t in result.trees])
    print(f"train_forest: {FOREST_TREES} trees on {FOREST_WORKERS} workers "
          f"in {train_s:.3f} s ({info['trees_per_s']:.4f} trees/s), "
          f"worker tasks {stats['worker_tasks']}; {steps.steps} supersteps "
          f"({steps.live} live), launches {launches}; members alone, "
          f"equal: {info['alone_s']} s")
    print(json.dumps(info))
    return result, fc, info


def score_oob(result, fc, syd, dev) -> dict:
    """Phase 5's OOB estimate: the traversal kernel, equal to the plain
    traversal, at the coverage 16 bootstraps give."""
    import math

    import torch
    from repro_torch.ensemble import oob
    from repro_torch.kernels import tree_infer

    split = {}
    tree_infer.LAUNCHES = 0
    r, oob_s = _timed(lambda: oob.oob_score(result.trees, syd, fc,
                                            device=dev, stats_out=split))
    launches = tree_infer.LAUNCHES
    check(launches == 1, f"oob_score launched the traversal {launches} "
          f"times")
    check(math.isfinite(r.score) and 0 <= r.score <= 1,
          f"OOB score {r.score}")
    want_cov = 1 - (1 - math.exp(-1)) ** FOREST_TREES
    check(abs(r.coverage - want_cov) < OOB_COVERAGE_TOL,
          f"OOB coverage {r.coverage} vs {want_cov:.6f}")
    plain, plain_s = _timed(lambda: oob.oob_score(result.trees, syd, fc,
                                                  impl="torch", device=dev))
    check(torch.equal(r.pred, plain.pred) and r.score == plain.score,
          f"OOB with the kernel != with the plain traversal at "
          f"{int((r.pred != plain.pred).sum())} cases")
    info = dict(score=r.score, coverage=r.coverage,
                expected_coverage=want_cov, n_covered=r.n_covered,
                oob_s=oob_s, plain_oob_s=plain_s, launches=launches,
                **{f"{k}": v for k, v in split.items()})
    print(f"oob: score {r.score:.6f}, coverage {r.coverage:.6f} (expected "
          f"{want_cov:.6f}) in {oob_s:.3f} s: pack {split['pack_s']:.3f}, "
          f"traversal with the rows' copy {split['predict_s']:.3f}, mask "
          f"{split['mask_s']:.3f}, vote {split['vote_s']:.3f}; the plain "
          f"traversal's OOB {plain_s:.3f} s, equal")
    print(json.dumps({"oob": info}))
    return info


def check_forest(trees, syd, census, cfg, gen, dev
                 ) -> tuple[dict, object, dict]:
    """Phase 5's traversal checks on the trained forest.  Returns
    (kernel record, the SyD forest, info)."""
    import dataclasses

    import torch
    from repro_torch.core.tree import Tree
    from repro_torch.infer import forest as F
    from repro_torch.kernels import autotune, ref, tree_infer
    # the many-trees case: SMALL_TREES random small trees, more than the
    # 65,535 of a grid's y extent
    from repro_torch.profile_infer import SMALL_SEED, SMALL_TREES, \
        device_ms, grow_forest, small_trees, traversal_bound

    fo = F.Forest.pack(trees, capacity=cfg.max_nodes, device=dev)
    t_dim, m_dim = fo.n_trees, fo.capacity
    check((t_dim, m_dim) == (FOREST_TREES, cfg.max_nodes),
          f"packed forest is {t_dim} x {m_dim}")

    x = torch.as_tensor(syd.x).to(dev)
    cont = torch.as_tensor(syd.attr_is_cont).to(dev)
    n, a_dim = x.shape
    tab, depth = fo.node_table(), fo.n_levels
    x_unk = _with_unknowns(x, gen)
    _infer_case(tab, depth, x, cont, "full shape")
    _infer_case(tab, depth, x_unk, cont, "full shape, 5% unknown")
    for rows in (1, 257, SERVE_MAX_BATCH):
        _infer_case(tab, depth, x_unk[:rows].contiguous(), cont,
                    f"N = {rows}")
    # the per-tree oracle (tree.predict per member) on a slice
    head = x_unk[:100_000].contiguous()
    check(torch.equal(F.predict_per_tree(fo, head, cont),
                      F.predict_per_tree(fo, head, cont, impl="ref")),
          "forest_predict != the per-tree oracle")
    # a lone leaf: every case gets its class, at any depth
    leaf = Tree.empty(1, syd.n_classes, device=dev)
    leaf.node_class[0] = 1
    leaf.n_nodes.fill_(1)
    lone = F.Forest.pack([leaf], device=dev)
    check(lone.n_levels == 1, f"lone leaf has {lone.n_levels} levels")
    _infer_case(lone.node_table(), 1, x_unk[:257].contiguous(), cont,
                "lone leaf")
    check(bool((F.predict(lone, x_unk[:257], cont) == 1).all()),
          "lone leaf forest does not predict its class")
    # wide discrete splits: a census_pums forest (A = 40)
    c_fo = F.Forest.pack(grow_forest(census, cfg, CENSUS_FOREST_TREES),
                         device=dev)
    c_tab, c_depth = c_fo.node_table(), c_fo.n_levels
    c_x = torch.as_tensor(census.x).to(dev)
    c_cont = torch.as_tensor(census.attr_is_cont).to(dev)
    _infer_case(c_tab, c_depth, c_x, c_cont, "census_pums")
    _infer_case(c_tab, c_depth, _with_unknowns(c_x, gen), c_cont,
                "census_pums, 5% unknown")
    # more trees than a grid's y dimension holds: small trees over a batch
    small, small_depth = small_trees(SMALL_TREES, a_dim, seed=SMALL_SEED,
                                     n_bins=SYD_BINS)
    small = torch.as_tensor(small).to(dev)
    batch = x[:SERVE_MAX_BATCH].contiguous()   # as phase 6 serves them
    _infer_case(small, small_depth, x_unk[:SERVE_MAX_BATCH].contiguous(),
                cont, f"T = {SMALL_TREES} small trees")

    # each regime of the plan: the kernel beside its bound
    regimes = []
    for name, t_, x_, c_, d_, reps in (
            (f"N={n}", tab, x, cont, depth, 5),
            (f"N={SERVE_MAX_BATCH}", tab, batch, cont, depth, 200),
            ("census_pums", c_tab, c_x, c_cont, c_depth, 10),
            (f"T={SMALL_TREES}", small, batch, cont, small_depth, 50)):
        plan = autotune.plan_infer_blocks(n_cases=x_.shape[0],
                                          n_trees=t_.shape[0])
        ms_ = device_ms(lambda: tree_infer.forest_predict(
            t_, x_, c_, max_depth=d_), reps)
        b = traversal_bound(t_, x_, c_, d_)
        regimes.append(dict(regime=name, T=t_.shape[0], M=t_.shape[1],
                            N=x_.shape[0], A=x_.shape[1], depth=d_,
                            kernel_ms=ms_, bound_ms=b["bound_ms"],
                            bound_by=b["bound_by"], steps=b["steps"],
                            plan=dataclasses.asdict(plan)))
        print(f"forest_predict {name}: T={t_.shape[0]} M={t_.shape[1]} "
              f"A={x_.shape[1]} depth={d_} {ms_:.4f} ms (bound "
              f"{b['bound_ms']:.5f} by {b['bound_by']}: bytes "
              f"{b['bytes_ms']:.5f}, operations {b['operations_ms']:.5f}); "
              f"plan {plan.mode}, {plan.threads} cases a block, "
              f"{plan.blocks} blocks")
    del small
    full, serving = regimes[0], regimes[1]
    plain_ms = cuda_ms(lambda: ref.forest_predict_ref(
        tab, x, cont, max_depth=depth), reps=2, warmup=1)
    plain_batch_ms = cuda_ms(lambda: ref.forest_predict_ref(
        tab, batch, cont, max_depth=depth), reps=10)
    # predict() as a user calls it, from host rows to labels on the card
    F.predict(fo, syd.x, syd.attr_is_cont)
    torch.cuda.synchronize()
    tree_infer.LAUNCHES = 0
    t0 = time.perf_counter()
    labels = F.predict(fo, syd.x, syd.attr_is_cont)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_launches = tree_infer.LAUNCHES
    check(predict_launches == 1,
          f"predict() launched the traversal kernel {predict_launches} times")
    acc = float((labels.cpu().numpy() == syd.y).mean())
    print(f"forest_predict: plain {plain_ms:.4f} ms at N={n}, "
          f"{plain_batch_ms:.4f} ms at N={SERVE_MAX_BATCH}; predict() "
          f"{predict_s * 1e3:.3f} ms, {predict_launches} launch")
    # the record's times and bound are those of one serving batch, the
    # shape of every launch that the serving run (phase 6) counts
    record = dict(
        name="forest_predict", route="cuda",
        source="src/repro_torch/kernels/csrc/tree_infer.cu",
        replaces="src/repro/kernels/tree_infer.py:103",
        jax="repro.kernels.tree_infer.forest_predict",
        max_abs_err=0, ms=serving["kernel_ms"],
        kernel_ms=serving["kernel_ms"], plain_ms=plain_batch_ms,
        bound_ms=serving["bound_ms"], bound_by=serving["bound_by"],
        library_ms=None,
        shape=dict(T=t_dim, M=m_dim, N=SERVE_MAX_BATCH, A=a_dim,
                   depth=depth),
        full_shape=dict(N=n, ms=full["kernel_ms"], plain_ms=plain_ms,
                        bound_ms=full["bound_ms"],
                        bound_by=full["bound_by"]),
        regimes=regimes)
    info = dict(forest_trees=t_dim, capacity=m_dim, n_levels=depth,
                descent_steps=full["steps"],
                tree_nodes=[t.size for t in trees], predict_s=predict_s,
                predict_launches=predict_launches,
                forest_batch_ms=serving["kernel_ms"],
                train_accuracy=acc, census_trees=c_fo.n_trees,
                census_capacity=c_fo.capacity)
    print(json.dumps(info))
    return record, fo, info


# --------------------------------------------------------------------------
# phase 6: the serving path
# --------------------------------------------------------------------------

def _crc(arr) -> int:
    import numpy as np
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def serve(fo, result, syd, oob_info, dev) -> dict:
    """publish_forest -> ModelHandle -> BatchPredictService ->
    forest_predict."""
    import numpy as np
    from repro_torch.ensemble import publish
    from repro_torch.infer import forest as F
    from repro_torch.infer import registry
    from repro_torch.infer.service import (BatchPredictService,
                                           InferReplica, PredictRequest)
    from repro_torch.kernels import tree_infer
    from repro_torch.obs.metrics import Registry

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_registry.", dir=build)
    try:
        tree_infer.LAUNCHES = 0
        path, publish_s = _timed(lambda: publish.publish_forest(
            root, "syd", result, syd, device=dev))
        publish_launches = tree_infer.LAUNCHES
        meta = registry.manifest_of(path)["metadata"]
        check(meta.get("oob_score") == oob_info["score"]
              and meta.get("oob_coverage") == oob_info["coverage"]
              and meta.get("tree_ids") == result.tree_ids
              and meta.get("quarantined") == [],
              f"published metadata {meta} != the trained forest's")
        check(publish_launches == 1, f"publish_forest's OOB launched the "
              f"traversal {publish_launches} times")
        handle = registry.ModelHandle(root, "syd", device=dev)
        check(handle.stable_path == path,
              f"the handle serves {handle.stable_path}, not {path}")
        check(handle.stable.device.type == "cuda",
              f"the handle's forest is on {handle.stable.device}")
        rows = syd.x[:SERVE_REQUESTS]
        want = F.predict(fo, rows, syd.attr_is_cont).cpu().numpy()
        metrics = Registry()
        service = BatchPredictService(
            [InferReplica.from_handle(handle, syd.attr_is_cont)
             for _ in range(SERVE_REPLICAS)],
            handle=handle, policy="ws", max_batch=SERVE_MAX_BATCH,
            metrics=metrics)
        tree_infer.LAUNCHES = 0
        t0 = time.perf_counter()
        for uid in range(SERVE_REQUESTS):
            service.submit(PredictRequest(uid=uid, x_row=rows[uid]))
        results = service.run_until_drained()
        serve_s = time.perf_counter() - t0
        launches = tree_infer.LAUNCHES
        check(not service.failed, f"{len(service.failed)} requests failed: "
              f"{service.failed[:3]}")
        check(len(results) == SERVE_REQUESTS,
              f"{len(results)} of {SERVE_REQUESTS} requests served")
        got = np.empty(SERVE_REQUESTS, np.int64)
        got[[r.uid for r in results]] = [r.label for r in results]
        check(np.array_equal(got, want),
              f"served labels != batched predict at "
              f"{int((got != want).sum())} requests")
        batches = int(sum(s["value"] for s in metrics.snapshot()[
            "infer_replica_batches_total"]["series"]))
        check(launches > 0 and launches == batches,
              f"{launches} traversal launches for {batches} batches")
        # the published version reads back bit for bit, the trained trees
        # packed as publish_forest packs them
        loaded, manifest = registry.load(path)
        packed = F.Forest.pack(result.trees, device=dev)
        for name, arr in packed.to_numpy().items():
            crc = _crc(arr)
            check(crc == manifest["arrays"][name]["crc32"]
                  and crc == _crc(loaded.to_numpy()[name]),
                  f"published {name} crc32 != the in-memory forest's")
        check(registry.verify(path), "published version fails verify()")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info = dict(requests=SERVE_REQUESTS, replicas=SERVE_REPLICAS,
                max_batch=SERVE_MAX_BATCH, publish_s=publish_s,
                publish_launches=publish_launches, serve_s=serve_s,
                requests_per_s=SERVE_REQUESTS / serve_s, batches=batches,
                tree_infer_launches=launches, stats=service.stats())
    print(f"serve: {SERVE_REQUESTS} requests in {serve_s:.3f} s "
          f"({info['requests_per_s']:.1f} requests/s), {batches} batches, "
          f"{launches} forest_predict launches")
    print(json.dumps(info))
    return info


# --------------------------------------------------------------------------
# phase 7: the flash kernel against its plain version
# --------------------------------------------------------------------------

def _flash_inputs(case, gen, dev):
    import torch
    b, s, h, kv, d, _, _, dtype = case
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=gen, device=dev).to(dt)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _live_pairs(s: int, window: int) -> int:
    """(q, k) pairs inside the causal window: sum over q of min(q+1, w)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _flash_bound(case) -> tuple[float, str]:
    b, s, h, kv, d, window, _, dtype = case
    size = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * b * s * h * d + 2 * b * s * kv * d) * size
    return bound(n_bytes, 4 * b * h * d * _live_pairs(s, window),
                 BF16_TENSOR_OPS_PER_S)


def _flash_case(case, gen, dev) -> float:
    import torch
    from repro_torch.kernels import flash_attention, ref
    *_, window, cap, dtype = case
    q, k, v = _flash_inputs(case, gen, dev)
    got = flash_attention.flash_attention(q, k, v, window=window,
                                          softcap=cap)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash: bad output {tuple(got.shape)} {got.dtype} at {case}")
    check(bool(torch.isfinite(got).all()), f"flash: non-finite at {case}")
    err = (got.float() - want.float()).abs().max().item()
    check(err <= FLASH_TOL[dtype], f"flash != plain at {case}: max |diff| "
          f"{err:.3g} > {FLASH_TOL[dtype]}")
    return err


def check_flash(gen, dev) -> dict:
    """Phase 7.  Returns the kernel's record (launches filled in later)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for case in FLASH_CASES + FLASH_FULL:
        err = _flash_case(case, gen, dev)
        max_err[case[-1]] = max(max_err[case[-1]], err)

    # timing at gemma2's layer shape, bf16 (the serving path's type)
    h, kv, d = GEMMA_LAYER["H"], GEMMA_LAYER["KV"], GEMMA_LAYER["D"]
    times = {}
    for window, cap in ((0, 0.0), (0, 50.0), (4096, 50.0)):
        case = (1, FLASH_S, h, kv, d, window, cap, "bfloat16")
        q, k, v = _flash_inputs(case, gen, dev)
        ms = cuda_ms(lambda: flash_attention.flash_attention(
            q, k, v, window=window, softcap=cap), reps=5)
        plain_ms = cuda_ms(lambda: ref.flash_attention_ref(
            q, k, v, window=window, softcap=cap), reps=3, warmup=1)
        times[(window, cap)] = (ms, plain_ms, *_flash_bound(case))
    # the library call: causal GQA SDPA at window 0, softcap 0, on
    # heads-major copies made outside the timed region; held to the kernel
    case = (1, FLASH_S, h, kv, d, 0, 0.0, "bfloat16")
    q, k, v = _flash_inputs(case, gen, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    mine = flash_attention.flash_attention(q, k, v)
    lib_err = (lib.float() - mine.float()).abs().max().item()
    check(lib_err <= FLASH_TOL["bfloat16"],
          f"flash != scaled_dot_product_attention: {lib_err:.3g}")
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
    ms, plain_ms, bound_ms, bound_by = times[(0, 0.0)]
    for (window, cap), (t, pt, bd, by) in times.items():
        print(f"flash_attention: S={FLASH_S} H={h} KV={kv} D={d} bf16 "
              f"window={window} softcap={cap}: {t:.4f} ms (plain {pt:.4f}, "
              f"bound {bd:.4f} by {by}, {t / bd:.2f}x; earlier scalar "
              f"kernel {FLASH_SCALAR_MS[(window, cap)]} ms)")
    print(f"flash_attention: scaled_dot_product_attention {library_ms:.4f} "
          f"ms at window 0, softcap 0 (max |diff| {lib_err:.3g}); max "
          f"|kernel - plain| f32 {max_err['float32']:.3g}, bf16 "
          f"{max_err['bfloat16']:.3g} over {len(FLASH_CASES + FLASH_FULL)} "
          f"shapes")
    glob, loc = times[(0, 50.0)], times[(4096, 50.0)]
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:127",
        jax="repro.kernels.flash_attention.flash_attention",
        max_abs_err=max(max_err.values()), max_abs_err_f32=max_err["float32"],
        max_abs_err_bf16=max_err["bfloat16"], ms=ms, kernel_ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, library_max_abs_diff=lib_err,
        global_layer=dict(window=0, softcap=50.0, ms=glob[0],
                          plain_ms=glob[1], bound_ms=glob[2]),
        local_layer=dict(window=4096, softcap=50.0, ms=loc[0],
                         plain_ms=loc[1], bound_ms=loc[2]),
        shape=dict(B=1, S=FLASH_S, H=h, KV=kv, D=d, dtype="bfloat16",
                   window=0, softcap=0.0))


def _bwd_inputs(case, dtype, gen, dev):
    """q scaled, k, v and dO of a backward case, and the forward kernel's
    output and LSE on them."""
    import torch
    from repro_torch.kernels import flash_attention
    b, s, h, kv, d, window, cap = case
    q, k, v = _flash_inputs((b, s, h, kv, d, window, cap, dtype), gen, dev)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(q.dtype)
    qs = flash_attention.scale_query(q)
    o, lse = flash_attention.flash_attention_fwd(
        qs, k, v, window=window, softcap=cap, with_lse=True)
    return qs, k, v, o, do, lse


def _bwd_case(case, dtype, gen, dev) -> tuple[float, float]:
    """The forward's LSE and unchanged output, then the backward kernel
    against the plain backward; (max |diff| of the gradients, of the
    LSE)."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    *_, window, cap = case
    kw = dict(window=window, softcap=cap)
    qs, k, v, o, do, lse = _bwd_inputs(case, dtype, gen, dev)
    serving = flash_attention.flash_attention_fwd(qs, k, v, **kw)
    _, want_lse = ref.flash_attention_fwd_ref(qs, k, v, **kw)
    got = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    check(torch.equal(o, serving), f"flash: writing the LSE changed the "
          f"output at {case} {dtype}")
    lse_err = (lse - want_lse).abs().max().item()
    check(lse_err <= LSE_ATOL, f"flash LSE != plain at {case} {dtype}: "
          f"{lse_err:.3g} > {LSE_ATOL}")
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"flash_bwd: bad {name} {tuple(g.shape)} {g.dtype} at {case}")
        check(bool(torch.isfinite(g).all()), f"flash_bwd: non-finite {name} "
              f"at {case} {dtype}")
        e = (g.float() - w.float()).abs().max().item()
        tol = (BWD_F32_ATOL if dtype == "float32" else
               BWD_BF16_REL * max(w.float().abs().max().item(), 1.0))
        check(e <= tol, f"flash_bwd != plain at {case} {dtype}: max |d{name}"
              f" diff| {e:.3g} > {tol:.3g}")
        err = max(err, e)
    return err, lse_err


def _bwd_bound(case, dtype) -> tuple[float, str]:
    """q, k, v, o, dO and the LSE read once, dq, dk, dv written once;
    10 * D flops a live (q, k) pair and head (S, dP, dV, dK, dQ)."""
    b, s, h, kv, d, window, _ = case
    size = 2 if dtype == "bfloat16" else 4
    n_bytes = (4 * b * s * h * d + 4 * b * s * kv * d) * size + b * h * s * 4
    return bound(n_bytes, 10 * b * h * d * _live_pairs(s, window),
                 BF16_TENSOR_OPS_PER_S)


def check_flash_bwd(gen, dev) -> dict:
    """Phase 7, the backward.  Returns the kernel's record (launches filled
    in by phase 11)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    max_lse = 0.0
    cases = BWD_CASES + list(BWD_LAYERS.values())
    for case in cases:
        for dtype in ("float32", "bfloat16"):
            err, lse_err = _bwd_case(case, dtype, gen, dev)
            max_err[dtype] = max(max_err[dtype], err)
            max_lse = max(max_lse, lse_err)
        torch.cuda.empty_cache()

    # times at the training layer shapes, bf16 (the training path's type)
    times = {}
    for name, case in BWD_LAYERS.items():
        *_, window, cap = case
        kw = dict(window=window, softcap=cap)
        qs, k, v, o, do, lse = _bwd_inputs(case, "bfloat16", gen, dev)
        ms = cuda_ms(lambda: flash_attention.flash_attention_bwd(
            qs, k, v, o, do, lse, **kw), reps=3, warmup=1)
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
            qs, k, v, o, do, lse, **kw), reps=2, warmup=1)
        library_ms = None
        if window == 0 and cap == 0:
            # torch autograd through causal GQA SDPA on the scaled q
            # (scale 1), heads-major leaves made outside the timed region;
            # never called by the port
            leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (qs, k, v)]
            out = F.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True, scale=1.0)
            do_t = do.transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, do_t, retain_graph=True), reps=3, warmup=1)
            del out, leaves
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           **dict(zip(("bound_ms", "bound_by"),
                                      _bwd_bound(case, "bfloat16"))))
        del qs, k, v, o, do, lse
        torch.cuda.empty_cache()
    for name, t in times.items():
        b, s, h, kv, d, window, cap = BWD_LAYERS[name]
        lib = ("" if t["library_ms"] is None else
               f", SDPA backward {t['library_ms']:.4f}")
        print(f"flash_attention_bwd: {name} B={b} S={s} H={h} KV={kv} D={d} "
              f"window={window} softcap={cap} bf16: {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f}{lib}; bound {t['bound_ms']:.4f} by "
              f"{t['bound_by']}, {t['ms'] / t['bound_ms']:.1f}x)")
    print(f"flash_attention_bwd: max |kernel - plain| f32 "
          f"{max_err['float32']:.3g}, bf16 {max_err['bfloat16']:.3g}; forward "
          f"LSE max |diff| {max_lse:.3g}, output unchanged, over "
          f"{len(cases)} shapes x 2 dtypes")
    glob = times["gemma3_4b_global"]
    return dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/layers.py:268",
        jax="repro.models.layers._flash_vjp_bwd (the custom VJP's backward, "
            "jnp, no pallas_call)",
        max_abs_err=max(max_err.values()), max_abs_err_f32=max_err["float32"],
        max_abs_err_bf16=max_err["bfloat16"], lse_max_abs_err=max_lse,
        ms=glob["ms"], kernel_ms=glob["ms"], plain_ms=glob["plain_ms"],
        bound_ms=glob["bound_ms"], bound_by=glob["bound_by"],
        library_ms=glob["library_ms"], layers=times,
        shape=dict(zip(("B", "S", "H", "KV", "D", "window", "softcap"),
                       BWD_LAYERS["gemma3_4b_global"]), dtype="bfloat16"))


# --------------------------------------------------------------------------
# phase 8: gemma2_9b serving at full width and depth
# --------------------------------------------------------------------------

def serve_lm(dev) -> dict:
    """Phase 8.  Returns what it measured, the flash launches included."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Request

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracer = Tracer()
    (cfg, model, params, engine), init_s = _timed(
        lambda: serve_mod.build_engine(
            LM_ARCH, reduced=False, n_replicas=1, n_slots=LM_SLOTS,
            max_seq=LM_MAX_SEQ, policy="ws", seed=LM_SEED, device=dev,
            tracer=tracer))
    n_params = sum(p.numel() for p in params.parameters())
    check(cfg.n_layers == 42 and n_params == cfg.param_count() + cfg.d_model,
          f"{LM_ARCH}: {cfg.n_layers} layers, {n_params} parameters")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    cache_bytes = sum(t.numel() * t.element_size()
                      for slot in engine.replicas[0].cache
                      for t in slot.values())
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in LM_PROMPTS]
    requests = [Request(uid=i, prompt=p, max_new_tokens=LM_MAX_NEW)
                for i, p in enumerate(prompts)]

    flash_attention.LAUNCHES = 0
    flash_attention.LAUNCHES_BY_DTYPE.update(bfloat16=0, float32=0)
    out = serve_mod.drain(engine, requests)
    launches = flash_attention.LAUNCHES
    by_dtype = dict(flash_attention.LAUNCHES_BY_DTYPE)
    peak = torch.cuda.max_memory_allocated()
    check(not engine.failed, f"{len(engine.failed)} requests failed: "
          f"{engine.failed[:2]}")
    check(out["completed"] == len(prompts) and all(
        len(c.tokens) == LM_MAX_NEW for c in engine.completed),
          f"{out['completed']} completions, tokens "
          f"{[len(c.tokens) for c in engine.completed]}")
    check(launches == cfg.n_layers * len(prompts),
          f"{launches} flash launches over the serve run, not "
          f"{cfg.n_layers} x {len(prompts)}")
    check(by_dtype == {"bfloat16": launches, "float32": 0},
          f"flash launches by dtype {by_dtype}: the bf16 serving path must "
          f"go through the tensor-core kernel only")
    spans = tracer.span_summary()
    admit_s = spans["engine.admit"]["total_us"] / 1e6
    tick_s = spans["replica0.tick"]["total_us"] / 1e6
    n_decode = out["tokens"] - len(prompts)

    # each first token is the argmax of a separate prefill of its prompt;
    # those prefills, on an idle card, time the first token
    first = {c.uid: c.tokens[0] for c in engine.completed}
    ttft = {}
    for i, p in enumerate(prompts):
        (logits, _), dt = _timed(lambda: model.prefill(
            params, torch.as_tensor(p, device=dev)[None], max_seq=len(p)))
        ttft[len(p)] = dt
        check(int(torch.argmax(logits, -1)[0]) == first[i],
              f"request {i} ({len(p)} tokens): first token {first[i]} != "
              f"the argmax of its prefill")
        if i == 0:
            kernel_logits = logits[0].float()
        del logits
    plain = build_model(cfg, impl="torch")
    (plain_logits, _), plain_s = _timed(lambda: plain.prefill(
        params, torch.as_tensor(prompts[0], device=dev)[None],
        max_seq=len(prompts[0])))
    plain_logits = plain_logits[0].float()
    diff = (kernel_logits - plain_logits)
    abs_err = diff.abs().max().item()
    rel_err = (diff.norm() / plain_logits.norm()).item()
    same_top = int(kernel_logits.argmax()) == int(plain_logits.argmax())
    check(rel_err <= LM_LOGIT_REL_TOL and abs_err <= LM_LOGIT_ABS_TOL,
          f"{LM_PROMPTS[0]}-token prefill logits, kernel vs plain attention: "
          f"relative L2 {rel_err:.3g} (limit {LM_LOGIT_REL_TOL}), max "
          f"|diff| {abs_err:.3g} (limit {LM_LOGIT_ABS_TOL})")
    n_prompt = sum(LM_PROMPTS)
    info = dict(
        arch=LM_ARCH, layers=cfg.n_layers, parameters=n_params,
        weight_bytes=weight_bytes, cache_bytes=cache_bytes,
        init_s=init_s, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
        prompts=list(LM_PROMPTS), max_new_tokens=LM_MAX_NEW,
        completed=out["completed"], tokens=out["tokens"],
        serve_s=out["seconds"], tok_per_s=out["tok_per_s"],
        admit_s=admit_s, prefill_tok_per_s_in_engine=n_prompt / admit_s,
        decode_s=tick_s, decode_tokens=n_decode,
        decode_tok_per_s=n_decode / tick_s,
        ticks=engine.stats()["ticks"], flash_launches=launches,
        flash_launches_by_dtype=by_dtype,
        ttft_s={str(k): v for k, v in ttft.items()},
        prefill_tok_per_s=n_prompt / sum(ttft.values()),
        plain_prefill_s=plain_s, logits_max_abs_diff=abs_err,
        logits_rel_l2=rel_err, logits_same_argmax=same_top,
        peak_bytes=peak, stats=engine.stats())
    for n, t in ttft.items():
        print(f"lm: time to first token, {n} tokens: {t * 1e3:.1f} ms")
    print(f"lm: prefill {info['prefill_tok_per_s']:.1f} tokens/s (8 "
          f"separate prefills); decode {info['decode_tok_per_s']:.2f} "
          f"tokens/s over {n_decode} tokens in {tick_s:.3f} s of ticks; "
          f"engine {out['tok_per_s']:.2f} tok/s ({out['tokens']} tokens in "
          f"{out['seconds']:.3f} s); peak memory {peak / 1e9:.3f} GB "
          f"(weights {weight_bytes / 1e9:.3f} GB, cache "
          f"{cache_bytes / 1e9:.3f} GB); {launches} flash launches")
    print(f"lm: {LM_PROMPTS[0]}-token logits kernel vs plain attention: "
          f"max |diff| {abs_err:.4g}, relative L2 {rel_err:.4g}, same argmax "
          f"{same_top}; plain prefill {plain_s:.3f} s")
    print(json.dumps(info))
    del engine, params, model, plain
    torch.cuda.empty_cache()
    return info


# --------------------------------------------------------------------------
# phase 11: LM training, gemma3_4b at full width and depth; 11b: resume
# --------------------------------------------------------------------------

def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _loss_and_grads(cfg, params, batch, impl) -> dict:
    """One loss-and-gradient evaluation through the ``impl`` attention
    pair: the loss, the global grad norm and three leaves' gradients."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import global_norm
    names = [n for n, _ in params.named_parameters()]
    last_global = max(i for i in range(cfg.n_layers)
                      if cfg.block_kind(i) == "global")
    keep = ("embed", "layers.0.attn.wq", f"layers.{last_global}.mlp.w_down")
    loss, _ = build_model(cfg, impl=impl).loss_fn(params, batch)
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(params.parameters()))))
    out = dict(loss=loss.item(), gnorm=global_norm(grads).item(),
               leaves={k: grads[k] for k in keep})
    del grads, loss
    return out


def train_lm(dev, card: str) -> dict:
    """Phase 11 on the card ``card`` (name, power limit).  Returns what it
    measured, the kernels' launches included."""
    import numpy as np
    import torch
    from repro_torch.configs import base as cfgbase
    from repro_torch.data.loader import LoaderConfig, ShardedLoader
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model

    torch.cuda.empty_cache()
    cfg = cfgbase.get_config(TRAIN_ARCH)
    # the kernel pair against the plain pair, on the weights train() starts
    # from (the same seed) and its first batch
    gen = torch.Generator(dev)
    gen.manual_seed(TRAIN_SEED)
    params = build_model(cfg).init(gen)
    n_params = sum(p.numel() for p in params.parameters())
    check(cfg.n_layers == 34 and n_params == cfg.param_count() + cfg.d_model,
          f"{TRAIN_ARCH}: {cfg.n_layers} layers, {n_params} parameters")
    batch = ShardedLoader(LoaderConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_S, vocab_size=cfg.vocab_size,
        seed=TRAIN_SEED)).next_batch()
    (kern, kern_s) = _timed(lambda: _loss_and_grads(cfg, params, batch,
                                                    "cuda"))
    (plain, plain_s) = _timed(lambda: _loss_and_grads(cfg, params, batch,
                                                      "torch"))
    loss_diff = abs(kern["loss"] - plain["loss"])
    gnorm_rel = abs(kern["gnorm"] - plain["gnorm"]) / plain["gnorm"]
    leaf_rel = {k: _rel_l2(kern["leaves"][k], plain["leaves"][k])
                for k in kern["leaves"]}
    del params, kern["leaves"], plain["leaves"]
    torch.cuda.empty_cache()
    print(f"train: first batch, kernel vs plain attention: loss "
          f"{kern['loss']:.6f} / {plain['loss']:.6f} (|diff| "
          f"{loss_diff:.3g}), grad norm {kern['gnorm']:.6g} / "
          f"{plain['gnorm']:.6g} (rel {gnorm_rel:.3g}), gradient relative "
          f"L2 {', '.join(f'{k} {v:.3g}' for k, v in leaf_rel.items())}; "
          f"{kern_s:.2f} s / {plain_s:.2f} s")
    check(loss_diff <= TRAIN_LOSS_ATOL and gnorm_rel <= TRAIN_GNORM_REL and
          all(v <= TRAIN_GRAD_REL_L2 for v in leaf_rel.values()),
          f"{TRAIN_ARCH} first batch, kernel vs plain attention: loss |diff| "
          f"{loss_diff:.3g} (limit {TRAIN_LOSS_ATOL}), grad norm rel "
          f"{gnorm_rel:.3g} (limit {TRAIN_GNORM_REL}), leaves {leaf_rel} "
          f"(limit {TRAIN_GRAD_REL_L2})")

    torch.cuda.reset_peak_memory_stats()
    flash_attention.reset_launches()
    out = train(TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS,
                global_batch=TRAIN_BATCH, seq_len=TRAIN_S, grad_accum=1,
                ckpt_dir=None, seed=TRAIN_SEED, log_every=1, device=dev)
    fwd = dict(flash_attention.LAUNCHES_BY_DTYPE)
    bwd = dict(flash_attention.LAUNCHES_BWD_BY_DTYPE)
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    nc, rem = cfg.n_layers // len(cfg.block_pattern), \
        cfg.n_layers % len(cfg.block_pattern)
    want_fwd = TRAIN_STEPS * (2 * nc * len(cfg.block_pattern) + rem)
    check(all(np.isfinite(hist)) and hist[-1] < hist[0],
          f"{TRAIN_ARCH} losses {hist}: not finite and falling")
    check(fwd == {"bfloat16": want_fwd, "float32": 0},
          f"forward kernel launches {fwd} over {TRAIN_STEPS} steps, not "
          f"{want_fwd // TRAIN_STEPS} bf16 a step")
    check(bwd == {"bfloat16": TRAIN_STEPS * cfg.n_layers, "float32": 0},
          f"backward kernel launches {bwd} over {TRAIN_STEPS} steps, not "
          f"{cfg.n_layers} bf16 a step")
    tokens = TRAIN_BATCH * TRAIN_S
    secs = out["seconds"]
    steady = secs[1:]
    info = dict(
        card=card, arch=TRAIN_ARCH, layers=cfg.n_layers, parameters=n_params,
        steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_S,
        losses=hist, step_s=secs, tokens_per_step=tokens,
        tok_per_s=[tokens / t for t in secs],
        steady_step_s=sum(steady) / len(steady),
        steady_tok_per_s=tokens * len(steady) / sum(steady),
        peak_bytes=peak, flash_fwd_launches=fwd, flash_bwd_launches=bwd,
        first_batch=dict(loss_kernel=kern["loss"], loss_plain=plain["loss"],
                         gnorm_kernel=kern["gnorm"],
                         gnorm_plain=plain["gnorm"], loss_abs_diff=loss_diff,
                         gnorm_rel_diff=gnorm_rel, grad_rel_l2=leaf_rel,
                         kernel_s=kern_s, plain_s=plain_s))
    for i, (l, t) in enumerate(zip(hist, secs)):
        print(f"train: step {i} loss {l:.4f} {t:.3f} s {tokens / t:.1f} "
              f"tokens/s")
    print(f"train: {TRAIN_ARCH} {n_params} parameters, B={TRAIN_BATCH} "
          f"S={TRAIN_S}: steps 1-{TRAIN_STEPS - 1} {info['steady_step_s']:.3f}"
          f" s each, {info['steady_tok_per_s']:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.3f} GB; flash launches forward {fwd}, backward "
          f"{bwd}; on {card}")
    del out
    torch.cuda.empty_cache()
    return info


def resume_lm(dev) -> dict:
    """Phase 11b: 4 steps straight against 2 steps, a checkpoint and a
    resume for 2 more, reduced gemma3_4b on the card; the losses must be
    equal and the checkpoint must verify."""
    import torch
    from repro_torch.launch.train import train
    from repro_torch.train import checkpoint as ckpt
    kw = dict(reduced=True, global_batch=TRAIN_BATCH, seq_len=RESUME_SEQ,
              log_every=100, device=dev)
    straight = train(TRAIN_ARCH, steps=4, **kw)["history"]
    (ROOT / "build").mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=ROOT / "build")
    try:
        train(TRAIN_ARCH, steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
        saved = ckpt.latest_valid(ck)
        check(saved is not None and saved.endswith("step_0000000002") and
              ckpt.verify(saved), f"resume: no valid step-2 checkpoint in "
              f"{ck} ({saved})")
        resumed = train(TRAIN_ARCH, steps=4, ckpt_dir=ck, ckpt_every=10,
                        **kw)["history"]
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check(resumed == straight[2:], f"resume: losses {resumed} after the "
          f"checkpoint != the straight run's {straight[2:]}")
    print(f"train: resume of reduced {TRAIN_ARCH} at {RESUME_SEQ} tokens: "
          f"losses {resumed} equal the straight run's")
    torch.cuda.empty_cache()
    return dict(straight=straight, resumed=resumed)


# --------------------------------------------------------------------------
# phase 9: the c45 oracle and the farm under chaos
# --------------------------------------------------------------------------

def _chaos(key_fn):
    """The JAX package's chaos: crash_p 0.2, worker 1 dead from its first
    task, and the farm's retry policy for it."""
    from repro_torch.core import faults
    from repro_torch.core.farm import FaultPolicy
    inj = faults.FaultInjector(seed=CHAOS_SEED, spec=faults.FaultSpec(
        crash_p=0.2, dead_workers=frozenset({1})), key_fn=key_fn)
    return inj, FaultPolicy(**CHAOS_FAULT)


def _check_chaos(what, stats, inj) -> dict:
    """Retries ran, nothing was quarantined, worker 1 died, and only the
    injected faults failed: the log's crashes plus the one attempt the
    dead worker took down."""
    crashes = sum(1 for _, _, action in inj.log if action == "crash")
    check(stats["failures"] > 0 and stats["retries"] > 0
          and stats["quarantined"] == 0 and stats["dead_workers"] == [1],
          f"{what}: farm stats {stats}")
    check(stats["failures"] == crashes + 1,
          f"{what}: {stats['failures']} failures, {crashes} injected "
          f"crashes and one dead worker")
    return {k: stats[k] for k in ("failures", "retries", "requeues",
                                  "timeouts", "quarantined",
                                  "dead_workers", "worker_tasks")}


def oracle_and_chaos(ds, frontier_tree, cfg, dev, task_trace) -> dict:
    """Phase 9: the sequential oracle on the card equals the CUDA frontier
    tree; the farm build and a farm-trained forest under chaos equal the
    oracle and the sequential trainer.  The oracle's task trace goes to
    ``task_trace``."""
    from repro_torch.core import c45, frontier
    from repro_torch.core.tree import trees_equal
    from repro_torch.ensemble import trainer

    if frontier_tree is None:
        frontier_tree = frontier.build(ds, cfg, device=dev)
    oracle, c45_s = _timed(lambda: c45.build(ds, cfg, device=dev,
                                             task_trace=task_trace))
    check(trees_equal(oracle, frontier_tree),
          f"c45 on the card ({oracle.size} nodes) != the impl='cuda' "
          f"frontier tree ({frontier_tree.size} nodes)")
    print(f"c45: {ds.n_cases} cases, {oracle.size} nodes in {c45_s:.3f} s "
          f"on the card, equal to the CUDA frontier tree")

    inj, fault = _chaos(lambda t: t.node_id)
    stats = {}
    farm_tree, farm_s = _timed(lambda: frontier.build_farm(
        ds, cfg, n_workers=CHAOS_WORKERS, injector=inj, fault=fault,
        stats_out=stats, device=dev))
    check(trees_equal(farm_tree, oracle), "the farm build under chaos != "
          "the c45 oracle")
    farm = _check_chaos("build_farm", stats, inj)
    print(f"build_farm: {CHAOS_WORKERS} workers under chaos in {farm_s:.3f}"
          f" s, equal to c45; {farm}")

    fc = trainer.ForestConfig(n_trees=CHAOS_FOREST_TREES, seed=0, grow=cfg)
    inj, fault = _chaos(lambda tid: tid)
    fstats = {}
    res, forest_s = _timed(lambda: trainer.train_forest(
        ds, fc, impl="frontier", n_workers=CHAOS_WORKERS, injector=inj,
        fault=fault, stats_out=fstats, device=dev))
    seq, seq_s = _timed(lambda: trainer.train_forest_sequential(
        ds, fc, impl="frontier", device=dev))
    check(res.tree_ids == list(range(CHAOS_FOREST_TREES))
          and all(trees_equal(a, b) for a, b in zip(res.trees, seq)),
          "the forest trained under chaos != train_forest_sequential")
    forest = _check_chaos("train_forest", fstats, inj)
    print(f"train_forest: {CHAOS_FOREST_TREES} trees under chaos in "
          f"{forest_s:.3f} s, sequentially {seq_s:.3f} s, equal; {forest}")
    return dict(cases=ds.n_cases, attrs=ds.n_attrs, c45_nodes=oracle.size,
                c45_s=c45_s, farm_build_s=farm_s, farm_build=farm,
                chaos_forest_s=forest_s, sequential_forest_s=seq_s,
                chaos_forest=forest)


# --------------------------------------------------------------------------
# phase 10: the paper's farm, simulated and measured
# --------------------------------------------------------------------------

def _speedups(trace, cost, *, strategy, policy, workers) -> dict:
    """Simulated speedup at each worker count, each within the model's
    bound."""
    from repro_torch.core import simulate
    out = {}
    for w in workers:
        sp = simulate.simulate(trace, n_workers=w, strategy=strategy,
                               policy=policy, cost=cost).speedup
        check(sp <= w + SPEEDUP_SLACK, f"simulated {strategy}/{policy} "
              f"speedup {sp} at {w} workers")
        out[str(w)] = sp
    return out


def farm_model(ds, cfg, dev, big_trace, big_c45_s) -> dict:
    """Phase 10: c45 on the card, timed, with its task trace; the farm
    build at FARM_WORKERS, each equal to it; the simulator calibrated on
    c45's seconds over that trace (and over phase 9's), gated on its
    invariants.  Returns the simulated and measured speedups."""
    import math

    from repro_torch.core import c45, frontier, simulate
    from repro_torch.core.tree import trees_equal

    trace = []
    oracle, c45_s = _timed(lambda: c45.build(
        ds, cfg, device=dev, task_trace=trace, capacity=cfg.max_nodes))
    check(len(trace) == oracle.size, f"c45 traced {len(trace)} tasks for "
          f"{oracle.size} nodes")
    measured = {}
    for w in FARM_WORKERS:
        tree, farm_s = _timed(lambda: frontier.build_farm(
            ds, cfg, n_workers=w, device=dev))
        check(trees_equal(tree, oracle), f"build_farm on {w} workers != "
              f"c45")
        measured[str(w)] = dict(seconds=farm_s, speedup=c45_s / farm_s)

    cm = simulate.calibrate(trace, c45_s)
    simulated = {f"{st}/{pol}": _speedups(trace, cm, strategy=st,
                                          policy=pol, workers=SIM_WORKERS)
                 for st in ("np", "nap") for pol in SIM_POLICIES}
    per_task = simulate.CostModel(kappa=0.0, task_fixed=c45_s / len(trace))
    fixed = {f"{st}/ws": _speedups(trace, per_task, strategy=st,
                                   policy="ws", workers=SIM_WORKERS)
             for st in ("np", "nap")}
    big_cm = simulate.calibrate(big_trace, big_c45_s)
    big = {f"{st}/ws": _speedups(big_trace, big_cm, strategy=st,
                                 policy="ws", workers=(8,))["8"]
           for st in ("np", "nap")}

    # the model's invariants
    zero = simulate.calibrate(trace, c45_s, task_fixed=0.0,
                              emit_overhead=0.0)
    seq = simulate.sequential_time(trace, zero)
    check(math.isclose(seq, c45_s, rel_tol=1e-9),
          f"calibrated sequential time {seq} != c45's {c45_s} s")
    for pol in SIM_POLICIES:
        for w in SIM_WORKERS:
            r = simulate.simulate(trace, n_workers=w, strategy="np",
                                  policy=pol, cost=zero)
            check(math.isclose(sum(r.worker_busy), r.seq_time,
                                rel_tol=1e-6),
                  f"np/{pol} at {w} workers: worker busy "
                  f"{sum(r.worker_busy)} != sequential {r.seq_time}")
    out = dict(cases=ds.n_cases, attrs=ds.n_attrs, nodes=oracle.size,
               c45_s=c45_s, kappa=cm.kappa, measured_farm=measured,
               simulated=simulated, simulated_fixed_task_cost=dict(
                   task_fixed_s=per_task.task_fixed, **fixed),
               scale_0_1=dict(cases=big_trace[0]["r"],
                              nodes=len(big_trace), c45_s=big_c45_s,
                              workers=8, **big))
    farm = ", ".join(f"{w} workers {m['speedup']:.3f}"
                     for w, m in measured.items())
    print(f"farm model: c45 {c45_s:.3f} s for {oracle.size} nodes; "
          f"build_farm speedup {farm}; simulated at 8 workers: nap/ws "
          f"{simulated['nap/ws']['8']:.3f}, np/ws "
          f"{simulated['np/ws']['8']:.3f}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this smoke run needs a GPU")
    from repro_torch.configs.yadt import WORKLOAD
    from repro_torch.data import datasets, quest
    from repro_torch.kernels import _build

    # ---- 0. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    times: dict[str, float] = {}

    # ---- 1. build the kernels (set-up time)
    t0 = time.perf_counter()
    logs = _build.build()
    times["kernel_build_s"] = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"kernel build: {times['kernel_build_s']:.2f} s")

    # ---- SyD10M9A data (set-up time)
    t0 = time.perf_counter()
    syd = quest.syd(SYD_CASES, seed=SYD_SEED, max_bins=SYD_BINS)
    times["syd_generate_s"] = time.perf_counter() - t0
    print(f"SyD10M9A: {syd.n_cases} cases, {syd.n_attrs} attributes, "
          f"max bins {syd.max_bins}, generated in "
          f"{times['syd_generate_s']:.2f} s")

    # ---- 2. kernels against their plain versions on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(SYD_SEED)
    x = torch.as_tensor(syd.x).to(dev)
    y = torch.as_tensor(syd.y).to(dev)
    w = torch.as_tensor(syd.w).to(dev)
    cont = torch.as_tensor(syd.attr_is_cont).to(dev)
    nb = torch.as_tensor(syd.n_bins, dtype=torch.int32).to(dev)
    t0 = time.perf_counter()
    hist_rec, sub_hist = check_histogram(
        x, y, w, syd.max_bins, syd.n_classes, WORKLOAD.grow.frontier_slots,
        gen, dev)
    gain_rec = check_split_gain(sub_hist, cont, nb, syd.max_bins, gen, dev)
    torch.cuda.synchronize()
    times["kernel_checks_s"] = time.perf_counter() - t0
    del x, y, w, sub_hist
    torch.cuda.empty_cache()

    # ---- 3. SyD10M9A, the build path
    cfg = WORKLOAD.grow
    t0 = time.perf_counter()
    build_launches, syd_tree, syd_info = grow_both("syd10m9a", syd, cfg,
                                                   dev)
    times["syd_builds_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    traced = traced_build("syd10m9a", syd, cfg, syd_tree, syd_info)
    times["syd_traced_build_s"] = time.perf_counter() - t0
    del syd_tree

    # ---- 4. census_pums: wide discrete splits
    t0 = time.perf_counter()
    census = datasets.load("census_pums", scale=CENSUS_SCALE,
                           max_bins=CENSUS_BINS)
    times["census_generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, census_tree, census_info = grow_both("census_pums", census, cfg, dev)
    times["census_builds_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # ---- 5. the forest from the trainer, its OOB score, the traversal
    t0 = time.perf_counter()
    result, fc, trained = train_syd_forest(syd, cfg, dev)
    times["train_forest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    oob_info = score_oob(result, fc, syd, dev)
    times["oob_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    infer_rec, forest, _ = check_forest(result.trees, syd, census, cfg, gen,
                                        dev)
    times["forest_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # ---- 6. the serving path: publish_forest -> registry -> service
    t0 = time.perf_counter()
    served = serve(forest, result, syd, oob_info, dev)
    times["serve_s"] = time.perf_counter() - t0

    # the training path's launches (phase 5), and each path's
    hist_rec["launches"] = trained["launches"]["frontier_histogram"]
    gain_rec["launches"] = trained["launches"]["split_gain"]
    for rec, key in ((hist_rec, "frontier_histogram"),
                     (gain_rec, "split_gain")):
        rec["launches_by_path"] = dict(build=build_launches[key],
                                       traced_build=traced["launches"][key],
                                       train_forest=trained["launches"][key])
    infer_rec["launches"] = served["tree_infer_launches"]
    infer_rec["launches_by_path"] = dict(
        oob_score=oob_info["launches"],
        publish_forest=served["publish_launches"],
        serve=served["tree_infer_launches"])

    del forest, syd, result
    torch.cuda.empty_cache()

    # ---- 7. the flash kernels against their plain versions
    t0 = time.perf_counter()
    flash_rec = check_flash(gen, dev)
    bwd_rec = check_flash_bwd(gen, dev)
    times["flash_s"] = time.perf_counter() - t0

    # ---- 8. gemma2_9b serving at full width and depth
    t0 = time.perf_counter()
    lm = serve_lm(dev)
    times["lm_serve_s"] = time.perf_counter() - t0
    flash_rec["launches"] = lm["flash_launches"]

    # ---- 9. the c45 oracle and the farm under chaos (census_pums)
    t0 = time.perf_counter()
    if CHAOS_SCALE != CENSUS_SCALE:
        census = datasets.load("census_pums", scale=CHAOS_SCALE,
                               max_bins=CENSUS_BINS)
        census_tree = None          # phase 4 grew the full set
    elif census_info["overflow"]:
        raise SmokeError("census_pums overflowed max_nodes in phase 4: the "
                         "c45 oracle grows freely, so the trees cannot "
                         "compare; cut CHAOS_SCALE")
    chaos_trace = []
    chaos = oracle_and_chaos(census, census_tree, cfg, dev, chaos_trace)
    times["chaos_s"] = time.perf_counter() - t0

    # ---- 10. the paper's farm, simulated and measured (census_pums 0.02)
    t0 = time.perf_counter()
    small = datasets.load("census_pums", scale=FARM_SCALE,
                          max_bins=CENSUS_BINS)
    model = farm_model(small, cfg, dev, chaos_trace, chaos["c45_s"])
    times["farm_model_s"] = time.perf_counter() - t0
    print(json.dumps({"farm_model": model}))

    # ---- 11. LM training, gemma3_4b at full width and depth; 11b. resume
    t0 = time.perf_counter()
    trained_lm = train_lm(dev, card)
    times["lm_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = resume_lm(dev)
    times["lm_resume_s"] = time.perf_counter() - t0
    bwd_rec["launches"] = trained_lm["flash_bwd_launches"]["bfloat16"]
    flash_rec["launches_by_path"] = dict(
        serve=lm["flash_launches"],
        train=trained_lm["flash_fwd_launches"]["bfloat16"])
    print(json.dumps({"train": dict(trained_lm, resume=resumed)}))

    print(json.dumps({"ensemble": dict(
        trees=FOREST_TREES, workers=FOREST_WORKERS,
        trees_per_s=trained["trees_per_s"], train_s=trained["train_s"],
        worker_tasks=trained["worker_tasks"],
        oob_score=oob_info["score"], oob_coverage=oob_info["coverage"],
        oob_s=oob_info["oob_s"], **{f"oob_{k}": oob_info[k] for k in (
            "pack_s", "predict_s", "mask_s", "vote_s")},
        chaos=chaos)}))
    print(json.dumps({"phase_seconds": times}))
    print(json.dumps({"kernels": [hist_rec, gain_rec, infer_rec,
                                  flash_rec, bwd_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
