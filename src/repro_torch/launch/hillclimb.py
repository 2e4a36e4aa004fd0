"""Layout-knob hillclimbing: count one cell under knob variants and diff
the roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama4_scout \
      --shape train_4k --knob moe2d

The port of ``repro.launch.hillclimb``, with the same JSON keys.  The cell
is counted partitioned on meta tensors over the 16x16 pod grid (a
``DeviceMesh`` over a fake process group, as the dry run's
``--mesh 16x16``): flops, bytes and collective bytes are one device's.
The knobs (``sharding.act``'s ``moe2d``, ``yadt_rs``, ``yadt_compact``,
``kv_seq_shard``) change the layouts the models' ``act`` calls ask for,
and so the count, as they change the JAX package's lowering.
``temp_gb`` is null (nothing runs).
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_mesh, production_shape
from repro_torch.launch.specs import make_analysis_cells, run_cell_step


def measure(arch: str, shape: str, **knobs) -> dict:
    t0 = time.time()
    flops = bytes_ = coll = 0.0
    coll_by_op: dict[str, float] = {}
    with fake_mesh(*production_shape(), device_type="cuda") as mesh:
        n = mesh.size()
        for acell, scale in make_analysis_cells(arch, shape, mesh):
            _, costs = run_cell_step(acell, mesh, count=True, **knobs)
            flops += scale * costs.device_flops
            bytes_ += scale * costs.device_bytes
            coll += scale * costs.coll_bytes
            for op, v in costs.coll_by_op.items():
                coll_by_op[op] = coll_by_op.get(op, 0.0) + scale * v
    model_flops = rl.model_flops_for(arch, shape)
    bw, _ = rl.collective_rate(n)
    return dict(
        knobs=knobs,
        temp_gb=None,
        flops=flops, bytes=bytes_, coll=coll, coll_by_op=coll_by_op,
        t_compute_ms=flops / rl.PEAK_FLOPS * 1e3,
        t_memory_ms=bytes_ / rl.HBM_BW * 1e3,
        t_collective_ms=coll / bw * 1e3,
        model_flops=model_flops,
        useful=model_flops / (flops * n) if flops else 0.0,
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
