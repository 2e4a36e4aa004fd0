"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last comes ``compared``, each number the check compared
beside its limit, which also close standard error.  Without a CUDA card
(or with fewer than the cell asks for), or without the port beside the
benchmark, it prints no result and exits with 2; if JAX or the JAX package
was loaded, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_loaded(modules) -> list[str]:
    """The modules of ``FORBIDDEN`` among ``modules``, by top-level name."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import spec
    try:
        spec_ = spec.Spec.load(ROOT)
        cell = spec_.cell(args.workload)
    except (FileNotFoundError, KeyError) as e:
        _err(f"no such workload: {e}")
        return 2
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        _err("CUDA is not available: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _err(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
        return 2
    torch.zeros(1, device="cuda")
    t_card = time.perf_counter()
    try:
        import repro_torch.core.frontier  # noqa: F401
    except ImportError as e:
        _err(f"the port (src/repro_torch) is not beside the benchmark: {e}")
        return 2
    from bench import harness
    t_port = time.perf_counter()
    _err(f"imports and card: torch {t_torch - T_START:.3f} s, card "
         f"{t_card - t_torch:.3f} s, port {t_port - t_card:.3f} s")

    out = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                           trace_on=bool(args.trace), device="cuda",
                           t_start=T_START, log=_err)
    run = out.pop("run")
    compared = out.pop("compared")
    metrics = harness.metrics(spec_, run, trace_on=bool(args.trace))
    loaded = forbidden_loaded(sys.modules)
    if loaded:
        _err(f"modules that may not run in the benchmark were loaded: "
             f"{loaded}")
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell.chips, memory_peak_bytes=run.peak_bytes,
                  card=_card())
    line = dict(out, metrics=metrics, device=device)
    if run.device is not None:
        device.update(busy_s=run.device.busy_s, window_s=run.device.window_s)
        line["breakdown"] = dict(
            device_ops=run.device.top(run.device.op_s),
            idle_gaps=run.device.top(run.device.idle_s))
    line["compared"] = compared
    ts = sorted(run.tree_s)
    _err(f"trees {run.n_trees}, window {run.window_s:.3f} s (a tree: min "
         f"{ts[0]:.4f}, median {ts[len(ts) // 2]:.4f}, max {ts[-1]:.4f} s), "
         f"setup {run.setup_s:.3f} s, card {device['card']}")
    for name, c in compared.items():
        _err(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
