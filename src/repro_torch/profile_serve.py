"""Device profile of gemma2_9b serving steps on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_serve

Builds gemma2_9b at full width and depth (42 layers, bf16, random weights
from seed 0, as ``chip_smoke.py`` phase 8 does) on the card, then times and
profiles three steps of the serving path, each once unprofiled (after a
warm-up) and once under ``torch.profiler`` with host and device activity:
a prefill of 33 tokens, a prefill of 7,000 tokens, and one decode tick of 4
slots at positions 7,000 / 5,121 / 4,096 / 3,000 of an 8,192-position
cache.  Prints one JSON object: per step the wall time, the device's busy
time and idle share, and the costliest device kernels and host operators.
It checks nothing; ``chip_smoke.py`` holds the kernel and the outputs.
"""

from __future__ import annotations

import json
import time

ARCH = "gemma2_9b"
SEED = 0
SHORT, LONG = 33, 7_000
SLOTS, MAX_SEQ = 4, 8_192
DECODE_POS = (7_000, 5_121, 4_096, 3_000)


def profile_step(fn, *, top: int = 10) -> dict:
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
    return dict(
        wall_s=wall, profiled_wall_s=profiled_wall,
        device_busy_s=busy_s if kernels else None,
        device_idle_share=1 - busy_s / profiled_wall if kernels else None,
        device_launches=sum(e.count for e in kernels),
        top_kernels=[dict(name=e.key[:80], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in sorted(kernels, key=lambda e:
                                     -e.self_device_time_total)[:top]],
        top_host_ops=[dict(name=e.key[:60], count=e.count,
                           self_cpu_ms=e.self_cpu_time_total / 1e3)
                      for e in sorted(host, key=lambda e:
                                      -e.self_cpu_time_total)[:top]])


def main() -> int:
    import subprocess

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.models.model import build_model

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = base.get_config(ARCH)
    model = build_model(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    params = model.init(gen)
    rng = np.random.default_rng(SEED)
    short = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, SHORT)),
                            device=dev)
    long = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, LONG)),
                           device=dev)
    cache = model.init_cache(SLOTS, MAX_SEQ, dev)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (SLOTS, 1)),
                             device=dev)
    pos = torch.as_tensor(DECODE_POS, device=dev)
    out = {
        f"prefill_{SHORT}": profile_step(
            lambda: model.prefill(params, short, max_seq=SHORT)),
        f"prefill_{LONG}": profile_step(
            lambda: model.prefill(params, long, max_seq=LONG)),
        "decode_tick": profile_step(
            lambda: model.decode_step(params, cache, tokens, pos)),
    }
    print(json.dumps({"card": card, "arch": ARCH, "profile": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
