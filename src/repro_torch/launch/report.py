"""Render the dry-run JSON into the roofline table (markdown).

  PYTHONPATH=src python -m repro_torch.launch.report build/dryrun.json

The port's copy of ``repro.launch.report``.  A null term renders as "not
counted" (the collective term of a JSON written before the partitioned
step counted it) or "not measured" (the temporary memory of a meta run); a
cell that does not fit is rendered with its
costs, and one that needs the device with the op that stopped it.  A JSON
of the JAX package's dry run renders as the JAX package renders it.
"""

from __future__ import annotations

import json
import sys


def fmt_ms(s: float | None) -> str:
    return "not counted" if s is None else f"{s*1e3:.1f}"


def fmt_gb(gb: float | None) -> str:
    return "not measured" if gb is None else f"{gb:.1f}"


def render(path: str) -> str:
    with open(path) as f:
        results = json.load(f)
    lines = [
        "| arch | shape | compute ms | memory ms | coll ms | bottleneck |"
        " useful-flops | mem/dev GB |",
        "|---|---|---:|---:|---:|---|---:|---:|",
    ]
    for key, r in results.items():
        status = r.get("status")
        if status not in ("ok", "does_not_fit"):
            label = "NEEDS DEVICE" if status == "needs_device" else "FAIL"
            lines.append(f"| {key.split('/')[0]} | {key.split('/')[1]} |"
                         f" {label} | | | {r.get('error', '')[:60]} | | |")
            continue
        if "t_compute" not in r:
            lines.append(
                f"| {r.get('arch', key.split('/')[0])} |"
                f" {r.get('shape', key.split('/')[1])} | compile-only |"
                f" | | | | {fmt_gb(r['mem_temp_gb'])} |")
            continue
        fit = (f" (does not fit: args {r['mem_args_gb']:.1f} GB)"
               if status == "does_not_fit" else "")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(r['t_compute'])} |"
            f" {fmt_ms(r['t_memory'])} | {fmt_ms(r['t_collective'])} |"
            f" {r['bottleneck']}{fit} | {r['useful_flops_ratio']:.2f} |"
            f" {fmt_gb(r['mem_temp_gb'])} |")
    return "\n".join(lines)


def summarize(path: str) -> str:
    with open(path) as f:
        results = json.load(f)
    ok = [k for k, r in results.items() if r.get("status") == "ok"]
    out = [f"{len(ok)}/{len(results)} cells OK"]
    for status, word in (("does_not_fit", "do not fit"),
                         ("needs_device", "need the device")):
        keys = [k for k, r in results.items() if r.get("status") == status]
        if keys:
            out.append(f"{word}: " + ", ".join(keys))
    fail = [k for k, r in results.items() if r.get("status") not in
            ("ok", "does_not_fit", "needs_device")]
    if fail:
        out.append("failed: " + ", ".join(fail))
    return "\n".join(out)


if __name__ == "__main__":
    p = sys.argv[1]
    print(summarize(p))
    print()
    print(render(p))
