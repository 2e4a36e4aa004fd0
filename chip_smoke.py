#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each one that fails ends the run with a non-zero exit):

  0. device: needs CUDA; prints the card's name and power limit.
  1. build: compiles the CUDA kernels of src/repro_torch/kernels/csrc with
     nvcc (sm_90a) into build/kernels/ and prints the build time.
  2. kernels: each kernel's wrapper against its plain torch version on the
     card, at the shapes of the SyD10M9A build and at edge shapes; times the
     kernel, the plain version and the library call.
  3. SyD10M9A at full size (10,000,000 cases, 9 attributes, 256 bins) grown
     with the defaults (the CUDA kernels) and collect_stats=True; both
     kernels must have been launched by that build.  Then one timed build
     each of the defaults and of impl="torch" on the same card, both without
     stats; all three trees must be equal.
  4. census_pums at scale 1.0 (299,285 cases, 40 attributes): the wide
     discrete-split case, impl="cuda" against impl="torch".

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  It imports nothing of JAX or of the JAX
package: the data generators and the grow configuration are the port's.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# SyD10M9A (paper Table 1) and the YaDTWorkload grow configuration of
# src/repro/configs/yadt.py: 10M cases, 256 bins, 2^18 nodes, 256 slots.
SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
GROW = dict(max_nodes=1 << 18, frontier_slots=256)
CENSUS_SCALE = 1.0
CENSUS_BINS = 128

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
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
    """Histogram kernel vs its plain version.  Returns (record, inputs for
    the split-gain check)."""
    import torch
    from repro_torch.kernels import compaction, histogram, ref
    kw = dict(n_slots=k, n_bins=n_bins, n_classes=n_classes)
    n, a_dim = ds_x.shape

    # the main path's root superstep: every case live in slot 0
    root_slot = torch.zeros((n,), dtype=torch.int32, device=dev)
    got = histogram.frontier_histogram(ds_x, ds_y, ds_w, root_slot, **kw)
    want = ref.frontier_histogram_ref(ds_x, ds_y, ds_w, root_slot, **kw)
    check(torch.equal(got, want), "histogram != plain at the root shape")
    max_err = 0.0

    # a deep superstep: 20% of the cases live over all K slots, gathered by
    # the compaction path as the build does
    live_slot = torch.randint(0, k, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
    live_slot[torch.rand((n,), generator=gen, device=dev) >= 0.2] = -1
    got = histogram.frontier_histogram(
        *compaction.live_cases(ds_x, ds_y, ds_w, live_slot), **kw)
    sub_hist = ref.frontier_histogram_ref(ds_x, ds_y, ds_w, live_slot, **kw)
    check(torch.equal(got, sub_hist), "compacted histogram != plain")

    # edge shapes: unknown bins, slot -1, B off any tile, C = 23, wide A
    edges = [(100_003, 5, 13, 23, 37), (50_000, 40, 128, 2, 256),
             (4_099, 3, 300, 3, 5), (1, 2, 1, 2, 1)]
    for (en, ea, eb, ec, ek) in edges:
        for integral in (True, False):
            x, y, w, s = _hist_inputs(gen, en, ea, eb, ec, ek, live=0.8,
                                      unknown=0.1, integral=integral,
                                      dev=dev)
            ekw = dict(n_slots=ek, n_bins=eb, n_classes=ec)
            got = histogram.frontier_histogram(x, y, w, s, **ekw)
            want = ref.frontier_histogram_ref(x, y, w, s, **ekw)
            if integral:
                check(torch.equal(got, want),
                      f"histogram != plain at {(en, ea, eb, ec, ek)}")
            else:
                # non-integral weights: atomics add in no fixed order
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
                      f"histogram !~ plain at {(en, ea, eb, ec, ek)}")
                max_err = max(max_err, (got - want).abs().max().item())

    # timing at the root shape (10M live cases)
    ms = cuda_ms(lambda: histogram.frontier_histogram(
        ds_x, ds_y, ds_w, root_slot, **kw), reps=10)
    plain_ms = cuda_ms(lambda: ref.frontier_histogram_ref(
        ds_x, ds_y, ds_w, root_slot, **kw), reps=3)
    flat = (((root_slot.long()[:, None] * a_dim
              + torch.arange(a_dim, device=dev)[None, :]) * (n_bins + 1)
             + torch.where(ds_x >= 0, ds_x, n_bins).long()) * n_classes
            + ds_y.long()[:, None]).reshape(-1)
    w_flat = ds_w[:, None].expand(n, a_dim).reshape(-1)
    lib_out = torch.zeros(((k + 1) * a_dim * (n_bins + 1) * n_classes,),
                          device=dev)
    library_ms = cuda_ms(lambda: lib_out.index_add_(0, flat, w_flat), reps=3)
    del flat, w_flat, lib_out
    out_bytes = k * a_dim * (n_bins + 1) * n_classes * 4
    bound_ms, bound_by = bound(n * (4 * a_dim + 12) + out_bytes, n * a_dim)
    sub_ms = cuda_ms(lambda: histogram.frontier_histogram(
        *compaction.live_cases(ds_x, ds_y, ds_w, live_slot), **kw), reps=5)
    print(f"histogram: root N={n} {ms:.4f} ms (plain {plain_ms:.4f}, "
          f"index_add_ {library_ms:.4f}, bound {bound_ms:.4f} by {bound_by}); "
          f"20%-live compacted {sub_ms:.4f} ms")
    record = dict(
        name="frontier_histogram", route="cuda",
        source="src/repro_torch/kernels/csrc/histogram.cu",
        replaces="src/repro/kernels/histogram.py:101",
        jax="repro.kernels.histogram.frontier_histogram",
        max_abs_err=max_err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=dict(N=n, A=a_dim, B1=n_bins + 1, C=n_classes, K=k))
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
                         (3, 4, 1, 2)]:
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
    ms = cuda_ms(lambda: sg.split_gain(hist, tw, cont, nb), reps=50)
    plain_ms = cuda_ms(lambda: ref.split_gain_ref(hist, tw, cont, nb),
                       reps=10)
    n_ops = k * a_dim * n_bins * (6 * c + 20)
    bound_ms, bound_by = bound(
        k * a_dim * n_bins * c * 4 + k * 4 + a_dim * 5 + k * a_dim * 8, n_ops)
    print(f"split_gain: K={k} A={a_dim} B={n_bins} C={c} {ms:.4f} ms "
          f"(plain {plain_ms:.4f}, bound {bound_ms:.6f} by {bound_by})")
    return dict(
        name="split_gain", route="cuda",
        source="src/repro_torch/kernels/csrc/split_gain.cu",
        replaces="src/repro/kernels/split_gain.py:77",
        jax="repro.kernels.split_gain.split_gain",
        max_abs_err=max_err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=dict(K=k, A=a_dim, B=n_bins, C=c))


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


def grow_both(name, ds, cfg, dev) -> dict:
    """Grow with the defaults (CUDA kernels) and with impl="torch" on the
    card; the trees must be equal.  Returns the launch counts of the first
    build, the main path's run."""
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
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this smoke run needs a GPU")
    from repro_torch.core.config import GrowConfig
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
        x, y, w, syd.max_bins, syd.n_classes, GROW["frontier_slots"], gen,
        dev)
    gain_rec = check_split_gain(sub_hist, cont, nb, syd.max_bins, gen, dev)
    torch.cuda.synchronize()
    times["kernel_checks_s"] = time.perf_counter() - t0
    del x, y, w, sub_hist
    torch.cuda.empty_cache()

    # ---- 3. SyD10M9A, the main path
    cfg = GrowConfig(**GROW)
    launches = grow_both("syd10m9a", syd, cfg, dev)
    hist_rec["launches"] = launches["frontier_histogram"]
    gain_rec["launches"] = launches["split_gain"]
    del syd

    # ---- 4. census_pums: wide discrete splits
    t0 = time.perf_counter()
    census = datasets.load("census_pums", scale=CENSUS_SCALE,
                           max_bins=CENSUS_BINS)
    times["census_generate_s"] = time.perf_counter() - t0
    grow_both("census_pums", census, cfg, dev)

    print(json.dumps({"phase_seconds": times}))
    print(json.dumps({"kernels": [hist_rec, gain_rec]}))
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
