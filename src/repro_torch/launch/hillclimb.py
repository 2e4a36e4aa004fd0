"""Layout-knob hillclimbing: count one cell under knob variants and diff
the roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama4_scout \
      --shape train_4k --knob moe2d

The port of ``repro.launch.hillclimb``, with the same JSON keys.  The cell
is counted on meta tensors over the 16x16 pod grid, its flops and bytes
the global count divided evenly.  The knobs (``sharding.act``'s
``moe2d``, ``yadt_rs``, ``yadt_compact``, ``kv_seq_shard``) are set for
the step, but they change nothing yet: the ``act`` helpers are the
identity on tensors that are not DTensors, and the port's models do not
call them (one card has nothing to lay out).  ``temp_gb`` is null (nothing
runs) and the collective term not counted.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.launch.specs import make_analysis_cells, run_cell_step


def measure(arch: str, shape: str, **knobs) -> dict:
    mesh = abstract_mesh(*production_shape())
    t0 = time.time()
    flops = bytes_ = 0.0
    for acell, scale in make_analysis_cells(arch, shape, mesh):
        _, costs = run_cell_step(acell, mesh, count=True, **knobs)
        flops += scale * costs.device_flops / mesh.size
        bytes_ += scale * costs.device_bytes / mesh.size
    model_flops = rl.model_flops_for(arch, shape)
    return dict(
        knobs=knobs,
        temp_gb=None,
        flops=flops, bytes=bytes_, coll=None, coll_by_op={},
        t_compute_ms=flops / rl.PEAK_FLOPS * 1e3,
        t_memory_ms=bytes_ / rl.HBM_BW * 1e3,
        t_collective_ms=None,
        model_flops=model_flops,
        useful=model_flops / (flops * mesh.size) if flops else 0.0,
        wall_s=round(time.time() - t0, 1),
    )


def parse_knobs(items: list[str]) -> dict:
    """``name=value`` (value parsed as JSON) or a bare ``name`` (true)."""
    knobs = {}
    for k in items:
        if "=" in k:
            name, val = k.split("=", 1)
            knobs[name] = json.loads(val)
        else:
            knobs[k] = True
    return knobs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--knob", action="append", default=[],
                    help="knob=value (value parsed as json; bare name=true)")
    args = ap.parse_args(argv)
    out = measure(args.arch, args.shape, **parse_knobs(args.knob))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
