"""Device time of the flash backward at the training layer shapes on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_flash_bwd
    PYTHONPATH=src python3 -m repro_torch.profile_flash_bwd --against OTHER/src

At gemma3_4b's global and local (window 1,024) layers and phi4_mini's (bf16,
S = 4,096, inputs from seed 0, the forward kernel's output and LSE) it times
``flash_attention_bwd`` (CUDA events over 10 calls after a warm-up), the
plain backward ``ref.flash_attention_bwd_ref`` and, at window 0, torch
autograd through causal GQA ``scaled_dot_product_attention`` (the library
yardstick, never called by the port), beside the operations bound (10 * D
flops a live pair and head at 989 TFLOP/s) and the device time of each
backward kernel in one profiled call (``torch.profiler``).  With
``--against``, the package of another checkout (e.g. a ``git archive`` of
the parent commit unpacked under ``build/``) and this one in turns on one
card: against, this, this, against, each in a process of its own.  Prints
one JSON line a run.  It checks nothing; ``chip_smoke.py`` holds the
kernels.
"""

from __future__ import annotations

import json
from pathlib import Path

SEED = 0
# (B, S, H, KV, D, window)
LAYERS = {
    "gemma3_4b_global": (2, 4_096, 8, 4, 256, 0),
    "gemma3_4b_local": (2, 4_096, 8, 4, 256, 1_024),
    "phi4_mini": (2, 4_096, 24, 8, 128, 0),
}
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


def _ms(fn, reps: int) -> float:
    import torch
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


def _kernels_ms(fn) -> dict:
    """Device ms of each flash_bwd kernel in one call of ``fn`` (after a
    warm-up call), by kernel name."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile
    fn()
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        m = re.search(r"flash_bwd_\w+", e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(0)] = (out.get(m.group(0), 0.0)
                               + e.self_device_time_total / 1e3)
    return out


def profile() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    out = {}
    for name, (b, s, h, kv, d, window) in LAYERS.items():
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev
                                   ).to(torch.bfloat16)
                       for shape in ((b, s, h, d), (b, s, kv, d),
                                     (b, s, kv, d), (b, s, h, d)))
        qs = flash_attention.scale_query(q)
        o, lse = flash_attention.flash_attention_fwd(qs, k, v, window=window,
                                                     with_lse=True)
        row = dict(
            ms=_ms(lambda: flash_attention.flash_attention_bwd(
                qs, k, v, o, do, lse, window=window), 10),
            plain_ms=_ms(lambda: ref.flash_attention_bwd_ref(
                qs, k, v, o, do, lse, window=window), 3),
            bound_ms=roofline.bound_ms(
                0, roofline.flash_bwd_flops(b, s, h, d, window),
                roofline.BF16_TENSOR_OPS_PER_S)[0], library_ms=None)
        row["kernels_ms"] = _kernels_ms(
            lambda: flash_attention.flash_attention_bwd(
                qs, k, v, o, do, lse, window=window))
        if window == 0:
            leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (qs, k, v)]
            lib = F.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True, scale=1.0)
            do_t = do.transpose(1, 2)
            row["library_ms"] = _ms(lambda: torch.autograd.grad(
                lib, leaves, do_t, retain_graph=True), 10)
            del lib, leaves
        out[name] = row
        del q, k, v, do, qs, o, lse
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse
    import subprocess
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="profile the repro_torch package in this "
                    "directory (run this file by its path for it)")
    ap.add_argument("--against", help="the src directory of another "
                    "checkout: profile it and this one in turns")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parents[1])
    if args.src:
        sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    if not args.src:
        runs = [("this", here)]
        if args.against:
            runs = [("against", args.against), ("this", here),
                    ("this", here), ("against", args.against)]
        for label, src in runs:
            res = subprocess.run([sys.executable, __file__, "--src", src],
                                 capture_output=True, text=True)
            if res.returncode:
                sys.stderr.write(res.stderr)
                raise SystemExit(f"the {label} run ({src}) failed")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"run": label, "src": src, **line}), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"card": card, "layers": profile()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
