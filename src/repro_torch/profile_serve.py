"""Device profile of serving steps on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_serve [--arch ARCH]
        [--layers N]

Builds ``--arch`` (default gemma2_9b) at full width and depth, or cut to
its first ``--layers`` layers (bf16, random weights from seed 0, as
``chip_smoke.py`` phases 8 and 12 do) on the card, then times and profiles
three steps of the serving path, each once unprofiled (after a warm-up) and
once under ``torch.profiler`` with host and device activity: a prefill of
33 tokens, a long prefill and one decode tick of 4 slots.  gemma2_9b takes
phase 8's shapes (a 7,000-token prefill; the tick at positions 7,000 /
5,121 / 4,096 / 3,000 of an 8,192-position cache), every other
architecture phase 12's (4,096 tokens; positions 4,096 / 1,152 / 128 / 33
of 4,352).  Prints one JSON object: per step the wall time, the device's
busy time and idle share, its time by kernel group (flash, cuBLAS
products, index/gather/scatter/sort kernels: the MoE's routing, gather
and combine and the cache writes, other) and the costliest device kernels
and host operators.  It checks nothing; ``chip_smoke.py`` holds the
kernels and the outputs.
"""

from __future__ import annotations

import argparse
import json
import time

SEED = 0
SHORT = 33
# (long prefill, cache positions, the tick's slot positions)
SHAPES = {"gemma2_9b": (7_000, 8_192, (7_000, 5_121, 4_096, 3_000))}
OTHER_SHAPE = (4_096, 4_352, (4_096, 1_152, 128, 33))
GROUPS = (("flash", ("flash_fwd",)),
          ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
          ("index_gather_scatter_sort", ("index", "gather", "scatter",
                                         "sort")))


def profile_step(fn, *, top: int = 10, groups=()) -> dict:
    """Wall time of ``fn`` (after a warm-up call), then one profiled call:
    device busy time and idle share, launches, the ``top`` costliest
    kernels and host operators.  ``groups``: (name, substrings) pairs; each
    kernel's device time goes to the first group with a substring in its
    name, else to ``other`` (``device_ms_by_group``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed()                                   # warm-up
    wall = timed()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        profiled_wall = timed()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    host = [e for e in events if e.device_type == DeviceType.CPU]
    by_group: dict[str, float] = {name: 0.0 for name, _ in groups}
    by_group["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        name = next((n for n, subs in groups
                     if any(sub in key for sub in subs)), "other")
        by_group[name] += e.self_device_time_total / 1e3
    return dict(
        wall_s=wall, profiled_wall_s=profiled_wall,
        device_busy_s=busy_s if kernels else None,
        device_idle_share=1 - busy_s / profiled_wall if kernels else None,
        device_launches=sum(e.count for e in kernels),
        device_ms_by_group=by_group if groups else None,
        top_kernels=[dict(name=e.key[:80], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in sorted(kernels, key=lambda e:
                                     -e.self_device_time_total)[:top]],
        top_host_ops=[dict(name=e.key[:60], count=e.count,
                           self_cpu_ms=e.self_cpu_time_total / 1e3)
                      for e in sorted(host, key=lambda e:
                                      -e.self_cpu_time_total)[:top]])


def main() -> int:
    import dataclasses
    import subprocess

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.models.model import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_9b",
                    choices=list(base.ARCH_IDS))
    ap.add_argument("--layers", type=int, default=None,
                    help="run the first N layers (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = base.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    long_len, max_seq, decode_pos = SHAPES.get(args.arch, OTHER_SHAPE)
    model = build_model(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    rng = np.random.default_rng(SEED)
    short = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, SHORT)),
                            device=dev)
    long = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, long_len)),
                           device=dev)
    cache = model.init_cache(len(decode_pos), max_seq, dev)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                          (len(decode_pos), 1)), device=dev)
    pos = torch.as_tensor(decode_pos, device=dev)
    out = {
        f"prefill_{SHORT}": profile_step(
            lambda: model.prefill(params, short, max_seq=SHORT),
            groups=GROUPS),
        f"prefill_{long_len}": profile_step(
            lambda: model.prefill(params, long, max_seq=long_len),
            groups=GROUPS),
        "decode_tick": profile_step(
            lambda: model.decode_step(params, cache, tokens, pos),
            groups=GROUPS),
    }
    print(json.dumps({"card": card, "arch": args.arch,
                      "layers": cfg.n_layers, "profile": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
