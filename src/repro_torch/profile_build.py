"""Device profile of one SyD10M9A build on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_build
    PYTHONPATH=src python3 -m repro_torch.profile_build --against OTHER/src

The second form profiles the port of another checkout (an earlier commit
unpacked with ``git archive``) and this one in turns, against, this, this,
against, each in a process of its own, so that the two compare on one card.

Grows the SyD10M9A tree (10,000,000 cases, seed 0, 256 bins; the grow
configuration ``repro_torch.configs.yadt.WORKLOAD.grow``, the same as
``chip_smoke.py``'s; a profile of another checkout gets this checkout's)
once unprofiled, for the build's wall time, and once
under ``torch.profiler`` with device activity only.  Prints one JSON object:
both wall times, the device's busy time and idle share of the profiled
build, the device time of the costliest kernels, and for each splitAtt
kernel (the histogram, split gain) its device time summed over the build's
launches beside the bound of the same launches (the histogram's also by
live cases a launch).  A third, unprofiled build
records each launch's shape for those bounds and counts the histogram's
launches by plan.  A fourth, ``impl="torch"``, times the library call
beside the histogram: each superstep's ``index_add_`` of the plain version
(CUDA events around the call alone, the card kept busy while the call is
queued); the trees are equal, so its launches have the kernel's shapes.
It checks no result; ``chip_smoke.py`` holds the kernels and the trees.
An earlier port reports no launches by plan and no library time.
"""

from __future__ import annotations

import dataclasses
import json
import time


def _this_roofline():
    """This checkout's ``launch/roofline.py`` (the H100's peaks and the
    kernels' bound formulas), loaded by path: with ``--against`` the
    profiled port is another checkout's, which may lack it."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parent / "launch" / "roofline.py"
    spec = importlib.util.spec_from_file_location("_this_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


roofline = _this_roofline()

SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
# Cycles the card spins before each timed index_add_, so that the call is
# queued before its start event runs (about 20 us at the H100's clock).
QUEUE_CYCLES = 40_000


def splitatt_launches(ds, cfg) -> tuple[list, list, dict]:
    """Of every kernel launch of one build, from a build through wrapped
    wrappers: the histogram's (cases, attributes, non-zero output cells),
    split gain's (K, A, B, C), and the histogram's launches by plan."""
    import torch

    from repro_torch.core import frontier
    from repro_torch.kernels import histogram, split_gain

    hist_wrapper, gain_wrapper = histogram.frontier_histogram, \
        split_gain.split_gain
    hist_shapes, gain_shapes = [], []
    plans = dict(getattr(histogram, "PLANS", {}))   # an earlier port: none

    def hist_recorded(x, *args, **kw):
        launches = histogram.LAUNCHES
        out = hist_wrapper(x, *args, **kw)
        if histogram.LAUNCHES > launches:
            hist_shapes.append((x.shape[0], x.shape[1],
                                int(torch.count_nonzero(out))))
        return out

    def gain_recorded(hist, *args, **kw):
        launches = split_gain.LAUNCHES
        out = gain_wrapper(hist, *args, **kw)
        if split_gain.LAUNCHES > launches:
            gain_shapes.append(tuple(hist.shape))
        return out

    histogram.frontier_histogram = hist_recorded
    split_gain.split_gain = gain_recorded
    try:
        frontier.build(ds, cfg)
    finally:
        histogram.frontier_histogram = hist_wrapper
        split_gain.split_gain = gain_wrapper
    by_plan = {k: v - plans.get(k, 0)
               for k, v in getattr(histogram, "PLANS", {}).items()}
    return hist_shapes, gain_shapes, by_plan


def histogram_bound_ms(n: int, a: int, cells: int) -> tuple[float, str]:
    """The kernel's own work: each case row (A int32 bins, label, weight,
    slot) read once, each non-zero output cell written once (the wrapper's
    ``torch.zeros`` writes the rest, outside the kernel); one add per
    (case, attr)."""
    return roofline.bound_ms(roofline.histogram_bytes(n, a, cells),
                             roofline.histogram_ops(n, a))


# Live-case classes of the histogram's launches, for the time by size.
SIZE_EDGES = (10_000, 100_000, 1_000_000, 5_000_000)


def histogram_by_size(prof, shapes, bounds) -> list[dict]:
    """The histogram kernel's launches of the profiled build, in launch
    order, paired with the recorded build's shapes (the builds are the
    same), summed by live cases: launches, cases, device ms, bound ms."""
    times = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                   for e in prof.events()
                   if "frontier_histogram_kernel" in e.name)
    if len(times) != len(shapes):
        return []
    edges = (0, *SIZE_EDGES, None)
    rows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        idx = [i for i, (n, _, _) in enumerate(shapes)
               if n >= lo and (hi is None or n < hi)]
        rows.append(dict(
            cases_from=lo, cases_below=hi, launches=len(idx),
            cases=sum(shapes[i][0] for i in idx),
            kernel_ms=sum(times[i][1] for i in idx) / 1e3,
            bound_ms=sum(bounds[i][0] for i in idx)))
    return rows


def split_gain_bound_ms(k: int, a: int, b: int, c: int) -> float:
    """The (K, A, B, C) f32 histogram and the small inputs read once, the
    (K, A) outputs written once (bytes bound it)."""
    return roofline.bound_ms(roofline.split_gain_bytes(k, a, b, c), 0)[0]


def index_add_ms(ds, cfg) -> tuple[float | None, int]:
    """Device time of the plain histogram's ``index_add_`` summed over one
    ``impl="torch"`` build, and its number of calls (None, 0 for a port
    without ``ref.histogram_scatter``)."""
    import torch

    from repro_torch.core import frontier
    from repro_torch.kernels import ref

    if not hasattr(ref, "histogram_scatter"):
        return None, 0
    plain = ref.frontier_histogram_ref
    events = []

    def timed(x, y, w, slot, *, n_slots, n_bins, n_classes):
        flat, src = ref.histogram_scatter(x, y, w, slot, n_slots=n_slots,
                                          n_bins=n_bins, n_classes=n_classes)
        shape = (n_slots + 1, x.shape[1], n_bins + 1, n_classes)
        hist = torch.zeros(shape, dtype=torch.float32, device=x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        hist.view(-1).index_add_(0, flat, src)
        end.record()
        events.append((start, end))
        return hist[:n_slots]

    ref.frontier_histogram_ref = timed
    try:
        frontier.build(ds, cfg, impl="torch")
    finally:
        ref.frontier_histogram_ref = plain
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events), len(events)


def profile(ds, cfg, *, top: int = 12) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    from repro_torch.core import frontier

    def timed_build() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frontier.build(ds, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_build()                      # warm-up: kernel load, allocator
    wall = timed_build()
    # device activity only: host-side op events would multiply the trace
    # (and its post-processing time) without adding device time
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall = timed_build()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    costliest = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # by name; split gain has a kernel per kind of plan
    hist = [e for e in kernels if "frontier_histogram_kernel" in e.key]
    gain = [e for e in kernels if "split_gain" in e.key]
    hist_shapes, gain_shapes, by_plan = splitatt_launches(ds, cfg)
    for name, found, shapes in (("histogram", hist, hist_shapes),
                                ("split gain", gain, gain_shapes)):
        if sum(e.count for e in found) != len(shapes):
            raise RuntimeError(
                f"{name} kernels in the profile: "
                f"{[(e.key, e.count) for e in found]}, {len(shapes)} "
                f"launches in the recorded build")
    bounds = [histogram_bound_ms(*shape) for shape in hist_shapes]
    by_size = histogram_by_size(prof, hist_shapes, bounds)
    library_ms, library_calls = index_add_ms(ds, cfg)
    return dict(
        build_wall_s=wall, profiled_wall_s=profiled_wall,
        device_busy_s=busy_s if kernels else None,
        device_idle_share=1 - busy_s / profiled_wall if kernels else None,
        top_kernels=[dict(name=e.key[:80], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in costliest[:top]],
        histogram=dict(
            launches=len(hist_shapes),
            launches_by_plan=by_plan,
            cases=sum(n for n, _, _ in hist_shapes),
            cells_written=sum(c for _, _, c in hist_shapes),
            kernel_ms=sum(e.self_device_time_total for e in hist) / 1e3,
            bound_ms=sum(t for t, _ in bounds),
            launches_bound_by_bytes=sum(by == "bytes" for _, by in bounds),
            library_ms=library_ms, library_calls=library_calls,
            by_live_cases=by_size),
        split_gain=dict(
            launches=len(gain_shapes),
            kernel_ms=sum(e.self_device_time_total for e in gain) / 1e3,
            bound_ms=sum(split_gain_bound_ms(*s) for s in gain_shapes)))


def compare(against: str) -> int:
    """Profile the port in ``against`` (the ``src`` directory of another
    checkout, such as an earlier commit's) and this one in turns: against,
    this, this, against, each in a process of its own.  One JSON line a
    run."""
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs.yadt import WORKLOAD

    here = str(Path(__file__).resolve().parents[1])
    grow = json.dumps(dataclasses.asdict(WORKLOAD.grow))
    for label, src in (("against", against), ("this", here),
                       ("this", here), ("against", against)):
        out = subprocess.run([sys.executable, __file__, "--src", src,
                              "--grow", grow],
                             capture_output=True, text=True, check=True)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, "src": src, **line}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    import subprocess
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="profile the repro_torch package in this "
                    "directory (run this file by its path for it)")
    ap.add_argument("--against", help="the src directory of another "
                    "checkout: profile it and this one in turns")
    ap.add_argument("--grow", help="the grow configuration's fields as "
                    "JSON (default: repro_torch.configs.yadt.WORKLOAD.grow; "
                    "a profile of another checkout gets this one's)")
    args = ap.parse_args(argv)
    if args.against:
        return compare(args.against)
    if args.src:
        sys.path.insert(0, args.src)

    import torch

    from repro_torch.core.config import GrowConfig
    from repro_torch.data import quest
    if args.grow:       # the fields this checkout's GrowConfig knows
        known = {f.name for f in dataclasses.fields(GrowConfig)}
        cfg = GrowConfig(**{k: v for k, v in json.loads(args.grow).items()
                            if k in known})
    else:
        from repro_torch.configs.yadt import WORKLOAD
        cfg = WORKLOAD.grow

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    syd = quest.syd(SYD_CASES, seed=SYD_SEED, max_bins=SYD_BINS)
    out = profile(syd, cfg)
    print(json.dumps({"card": card, "profile": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
