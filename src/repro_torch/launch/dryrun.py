"""Dry run of every (architecture x input shape) cell: its cost against one
H100's roofline, whether it fits, and on the card its measured step.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_9b \\
      --shape train_4k [--mesh 1|2x4|16x16] [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out build/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cuda \\
      --arch gemma3_4b --shape train_4k --batch 2

The port of ``repro.launch.dryrun``.  ``--device meta`` (the default; runs
on the CPU) builds the cell on meta tensors at its global shape and runs
its step once under the flop and byte counters (``launch.roofline``):

  * on ``--mesh 1`` (one card) the counts and the arguments are the
    device's, and the collective term 0;
  * on ``2x4`` or ``16x16`` (``--multi-pod``: 2x16x16) the step is
    partitioned (``"split": "partitioned"``): a ``DeviceMesh`` of that
    shape over torch's fake process group, made for the cell and torn down
    after it (``launch.mesh.fake_mesh``), the arguments laid out as
    DTensors by their specs and the step run on them
    (``specs.run_cell_step``), so that flops, bytes and the collectives
    (``device_coll_bytes``, ``coll_by_op``, ``t_collective`` at the mesh's
    collective rate) are one device's own; ``mem_args_gb`` is exact, every
    argument laid out by its spec (``partitioning.shard_shape``);
  * ``mem_temp_gb`` is null (nothing runs, so nothing is measured);
  * the status is ``ok``, ``does_not_fit`` (a device's arguments over the
    card's 80 GB) or ``needs_device`` (the step asked a meta tensor for its
    data: ``op`` and ``where`` name the call, e.g. the ``nonzero`` of the
    frontier's splitPre); an error is ``fail`` and the run exits 1.

``--device cuda`` runs the cell on one card at ``--batch`` rows (default:
the global batch): once to warm up, then three timed steps, each ending in
``torch.cuda.synchronize()``; it adds the card (``nvidia-smi``), the batch,
``step_ms``, ``peak_mem_gb`` (``max_memory_allocated`` since a reset after
the arguments were made), ``bound_s`` and ``roofline_share = bound_s /
step time``, and counts the costs in a separate, untimed run.  Without a
card it raises; it never runs on the CPU instead, and it takes only
``--mesh 1``.  No environment variable is set; a process group is made
only for a mesh cell on meta tensors, inside :func:`run_cell`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
import traceback

from repro_torch.configs import base as cfgbase
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs
from repro_torch.launch.mesh import abstract_mesh, fake_mesh, production_shape

TIMED_STEPS = 3
DEVICES = ("meta", "cuda")
MESHES = ("1", "2x4", "16x16")


def mesh_for(mesh: str = "1", *, multi_pod: bool = False):
    """``"1"``: one card; ``"2x4"``: the JAX test mesh (data 2, model 4);
    ``"16x16"``: the pod grid (``multi_pod``: two pods), as an abstract
    mesh (axis names and sizes)."""
    if mesh == "1" and not multi_pod:
        return specs.one_device_mesh(), "1"
    if mesh not in MESHES:
        raise ValueError(f"--mesh must be one of {MESHES}, got {mesh!r}")
    if mesh == "2x4" and not multi_pod:
        m = abstract_mesh((2, 4), ("data", "model"))
    else:
        m = abstract_mesh(*production_shape(multi_pod=multi_pod))
    return m, m.desc


def partitioned(m):
    """A context giving the mesh a cell runs on: the abstract mesh itself
    for one device, else a ``DeviceMesh`` of its shape over a fake process
    group of its size (meta-device collectives: DTensor lays them out as
    on the card's NCCL group), torn down on exit."""
    if m.size == 1:
        return contextlib.nullcontext(m)
    return fake_mesh(m.sizes, m.axis_names, device_type="cuda")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _finite(out) -> bool:
    """Every floating tensor of a step's output is finite, but for those
    of 2^26 elements or more (a cache, which is an argument)."""
    import torch
    return all(bool(torch.isfinite(t).all()) for t in rl.tree_tensors(out)
               if t.is_floating_point() and t.numel() < 1 << 26)


def _time_steps(cell, mesh) -> tuple[list[float], float, bool]:
    """(the timed steps' ms, the peak bytes, whether the last step's
    outputs are finite) after one warm-up step."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = specs.run_cell_step(cell, mesh)
    torch.cuda.synchronize()
    ms = []
    for _ in range(TIMED_STEPS):
        del out
        t0 = time.perf_counter()
        out = specs.run_cell_step(cell, mesh)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = float(torch.cuda.max_memory_allocated())
    return ms, peak, _finite(out)


def run_cell(arch: str, shape_name: str, *, mesh: str = "1",
             multi_pod: bool = False, device: str = "meta",
             batch: int | None = None, verbose: bool = True,
             analyze: bool = True) -> dict:
    """Build one cell, count its step, and on the card time it."""
    if device not in DEVICES:
        raise ValueError(f"--device must be one of {DEVICES}, got {device!r}")
    m, mesh_desc = mesh_for(mesh, multi_pod=multi_pod)
    if device == "cuda" and m.size != 1:
        raise ValueError("--device cuda runs on one card: --mesh 1")
    with partitioned(m) as dm:
        return _run_cell(arch, shape_name, m, dm, mesh_desc, device=device,
                         batch=batch, verbose=verbose, analyze=analyze)


def _run_cell(arch, shape_name, m, dm, mesh_desc, *, device, batch,
              verbose, analyze) -> dict:
    t0 = time.time()
    cell = specs.make_cell(arch, shape_name, m, device=device, batch=batch)
    t_prod = time.time() - t0
    arg_bytes = specs.device_arg_bytes(cell, m)
    global_batch = cfgbase.SHAPES[shape_name].global_batch
    out = dict(status="ok", device=device, t_prod_s=round(t_prod, 1),
               mem_args_gb=arg_bytes / 1e9, mem_temp_gb=None,
               mem_out_gb=None, batch=cell.batch,
               global_batch=(cell.batch if arch == "yadt" else global_batch),
               grad_accum=cell.grad_accum,
               split="partitioned" if m.size > 1 else None)
    if arg_bytes > rl.HBM_BYTES:
        out["status"] = "does_not_fit"
    step_ms = peak = None
    if device == "cuda":
        out["device"] = card()
        step_ms, peak, finite = _time_steps(cell, m)
        out.update(step_ms=sum(step_ms) / len(step_ms), step_ms_each=step_ms,
                   peak_mem_gb=peak / 1e9, outputs_finite=finite,
                   mem_temp_gb=(peak - arg_bytes) / 1e9)
    if verbose:
        split = f" | split: {out['split']}" if out["split"] else ""
        print(f"[{arch} x {shape_name} x {mesh_desc} on {device}] built in "
              f"{t_prod:.0f}s | memory/device: args "
              f"{out['mem_args_gb']:.2f} GB | {out['status']}{split}")
    if not analyze:
        return out
    t0 = time.time()
    try:
        res, costs = specs.run_cell_step(cell, dm, count=True)
        del res
    except rl.NeedsDevice as e:
        out.update(status="needs_device", op=e.op, where=e.where,
                   error=f"needs_device: {e.op} at {e.where}")
        if verbose:
            print(f"  needs the device: {e.op} at {e.where}")
        return out
    report = rl.analyze(costs, arch=arch, shape=shape_name,
                        mesh_desc=mesh_desc, n_devices=m.size,
                        peak_mem_bytes=peak, arg_bytes=arg_bytes,
                        batch=cell.batch)
    out.update(t_analysis_s=round(time.time() - t0, 1),
               mem_out_gb=costs.out_bytes / 1e9,
               **report.as_dict(m.size))
    if step_ms is not None:
        out["roofline_share"] = report.bound_s / (out["step_ms"] / 1e3)
    if verbose:
        coll = f"{report.t_collective * 1e3:.2f} ms" + (
            f" ({report.coll_link})" if m.size > 1 else "")
        print(f"  costs/device: {report.device_flops:.3e} flops, "
              f"{report.device_bytes:.3e} B, min {report.min_bytes:.3e} B "
              f"({out['t_analysis_s']:.0f}s)")
        print(f"  roofline: compute {report.t_compute * 1e3:.2f} ms | "
              f"memory {report.t_memory * 1e3:.2f} ms | collective {coll} "
              f"-> {report.bottleneck} | bound {report.bound_s * 1e3:.2f} ms"
              f" by {report.bound_by} | useful-flops "
              f"{report.useful_flops_ratio(m.size):.2f}")
        if report.coll_by_op:
            print("  collectives/device: " + ", ".join(
                f"{op} {b:.3e} B" for op, b in report.coll_by_op.items()))
        if step_ms is not None:
            print(f"  card: {out['device']}, batch {cell.batch} of "
                  f"{out['global_batch']}: step {out['step_ms']:.2f} ms, "
                  f"share {out['roofline_share']:.3f}, peak "
                  f"{out['peak_mem_gb']:.2f} GB")
    return out


def cells_to_run() -> list[tuple[str, str]]:
    cells = []
    for arch in cfgbase.ARCH_IDS + cfgbase.TREE_ARCH_IDS:
        if arch == "yadt":
            cells.append((arch, "train_4k"))
            continue
        cfg = cfgbase.get_config(arch)
        for shape in cfgbase.runnable_shapes(cfg):
            cells.append((arch, shape.name))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="build + memory only (multi-pod default)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mesh", default="1", choices=MESHES)
    ap.add_argument("--device", default="meta", choices=DEVICES)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch run (default: the shape's)")
    args = ap.parse_args(argv)

    analyze = not (args.no_analysis or args.multi_pod)
    todo = cells_to_run() if args.all else [(args.arch, args.shape)]
    results = {}
    for arch, shape in todo:
        key = f"{arch}/{shape}"
        try:
            results[key] = run_cell(arch, shape, mesh=args.mesh,
                                    multi_pod=args.multi_pod,
                                    device=args.device, batch=args.batch,
                                    analyze=analyze)
        except Exception as e:                        # record, keep going
            traceback.print_exc()
            results[key] = dict(status="fail", error=f"{type(e).__name__}: {e}")
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    by = {s: sum(r["status"] == s for r in results.values())
          for s in ("ok", "does_not_fit", "needs_device", "fail")}
    mesh_desc = mesh_for(args.mesh, multi_pod=args.multi_pod)[1]
    print(f"\n== {by['ok']}/{len(results)} cells OK, {by['does_not_fit']} "
          f"do not fit, {by['needs_device']} need the device, {by['fail']} "
          f"failed (mesh {mesh_desc}, {args.device})")
    if by["fail"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
