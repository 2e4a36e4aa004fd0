"""Read the check's two readings for a cell, on the card, at its own size.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3]

For each seed it makes the cell's inputs, grows one tree through the port
(the path the window times) and counts the nodes that differ from the
reference's: the lower reading of ``mismatched_nodes``.  For each control
seed it grows the tree with the reference itself in bfloat16, the
precision below the float32 the configuration states, and counts its
nodes that differ from the float64 reference's: the control's reading,
which has to fail.  One JSON line a seed; all in one process, so that the
card is set up once.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness, reference, spec
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.Spec.load(ROOT).cell(args.workload)
    config = spec.config(cell.config)
    grow = {**config["grow"], **spec.traffic(cell.traffic).get("grow", {})}
    g = reference.Grow.of(grow)
    build = harness.port_builder(grow, "cuda")
    gen = spec.generator(config["generator"])

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    for seed, control in ([(s, False) for s in seeds(args.seeds)]
                          + [(s, True) for s in seeds(args.control_seeds)]):
        data = gen.generate(config, seed, "cuda")
        shape = dict(n_bins=data.n_bins, attr_is_cont=data.attr_is_cont,
                     n_classes=data.n_classes)
        t0 = time.perf_counter()
        if control:
            tested = reference.grow(data.x, data.y, grow=g,
                                    dtype=torch.bfloat16, **shape).tree
        else:
            tested = harness.host_tree(build(harness.dataset(data)))
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        ref = reference.grow(data.x, data.y, grow=g, tested=tested, **shape)
        t2 = time.perf_counter()
        print(json.dumps(dict(
            workload=cell.name, seed=seed,
            side="control" if control else "program",
            mismatched_nodes=reference.compare(tested, ref.tree),
            near_ties=ref.near_ties, tie_share=ref.tie_share,
            nodes=len(tested["node_attr"]),
            reference_nodes=ref.n_nodes, overflow=ref.overflow,
            tested_s=round(t1 - t0, 3), reference_s=round(t2 - t1, 3))),
            flush=True)
        del data, tested, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
