"""Device profile of one SyD10M9A build on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_build

Grows the SyD10M9A tree (10,000,000 cases, seed 0, 256 bins; the
YaDTWorkload grow configuration of ``src/repro/configs/yadt.py``, the same
as ``chip_smoke.py``) once unprofiled, for the build's wall time, and once
under ``torch.profiler`` with device activity only.  Prints one JSON object:
both wall times, the device's busy time and idle share of the profiled
build, and the device time of the costliest kernels.  It checks nothing;
``chip_smoke.py`` holds the kernels and the trees.
"""

from __future__ import annotations

import json
import time

SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
GROW = dict(max_nodes=1 << 18, frontier_slots=256)


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
    return dict(
        build_wall_s=wall, profiled_wall_s=profiled_wall,
        device_busy_s=busy_s if kernels else None,
        device_idle_share=1 - busy_s / profiled_wall if kernels else None,
        top_kernels=[dict(name=e.key[:80], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in costliest[:top]])


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
