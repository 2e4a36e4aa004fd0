"""Device profile of one SyD10M9A build on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_build

Grows the SyD10M9A tree (10,000,000 cases, seed 0, 256 bins; the
YaDTWorkload grow configuration of ``src/repro/configs/yadt.py``, the same
as ``chip_smoke.py``) once unprofiled, for the build's wall time, and once
under ``torch.profiler`` with device activity only.  Prints one JSON object:
both wall times, the device's busy time and idle share of the profiled
build, the device time of the costliest kernels, and the histogram kernel's
device time summed over the build's launches beside the bound of the same
launches.  A third, unprofiled build records each launch's shape for that
bound.  It checks no result; ``chip_smoke.py`` holds the kernels and the
trees.
"""

from __future__ import annotations

import json
import time

SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
GROW = dict(max_nodes=1 << 18, frontier_slots=256)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory, and the
# CUDA cores' f32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def histogram_launches(ds, cfg) -> list[tuple[int, int, int]]:
    """(cases, attributes, non-zero output cells) of every histogram kernel
    launch of one build, from a build through a wrapped wrapper."""
    import torch

    from repro_torch.core import frontier
    from repro_torch.kernels import histogram

    wrapper = histogram.frontier_histogram
    shapes = []

    def recorded(x, *args, **kw):
        launches = histogram.LAUNCHES
        out = wrapper(x, *args, **kw)
        if histogram.LAUNCHES > launches:
            shapes.append((x.shape[0], x.shape[1],
                           int(torch.count_nonzero(out))))
        return out

    histogram.frontier_histogram = recorded
    try:
        frontier.build(ds, cfg)
    finally:
        histogram.frontier_histogram = wrapper
    return shapes


def histogram_bound_ms(n: int, a: int, cells: int) -> tuple[float, str]:
    """The kernel's own work: each case row (A int32 bins, label, weight,
    slot) read once, each non-zero output cell written once (the wrapper's
    ``torch.zeros`` writes the rest, outside the kernel); one add per
    (case, attr)."""
    t_bytes = (n * (4 * a + 12) + cells * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = n * a / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    hist = [e for e in kernels if "frontier_histogram_kernel" in e.key]
    shapes = histogram_launches(ds, cfg)
    if len(hist) != 1 or hist[0].count != len(shapes):
        raise RuntimeError(
            f"histogram kernel in the profile: "
            f"{[(e.key, e.count) for e in hist]}, {len(shapes)} launches in "
            f"the recorded build")
    bounds = [histogram_bound_ms(*shape) for shape in shapes]
    return dict(
        build_wall_s=wall, profiled_wall_s=profiled_wall,
        device_busy_s=busy_s if kernels else None,
        device_idle_share=1 - busy_s / profiled_wall if kernels else None,
        top_kernels=[dict(name=e.key[:80], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in costliest[:top]],
        histogram=dict(
            launches=len(shapes), cases=sum(n for n, _, _ in shapes),
            cells_written=sum(c for _, _, c in shapes),
            kernel_ms=hist[0].self_device_time_total / 1e3,
            bound_ms=sum(t for t, _ in bounds),
            launches_bound_by_bytes=sum(by == "bytes" for _, by in bounds)))


def main() -> int:
    import subprocess

    import torch

    from repro_torch.core.config import GrowConfig
    from repro_torch.data import quest

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    syd = quest.syd(SYD_CASES, seed=SYD_SEED, max_bins=SYD_BINS)
    out = profile(syd, GrowConfig(**GROW))
    print(json.dumps({"card": card, "profile": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
