"""Wall times of forest training, the c45 oracle and the farm build on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_train
    PYTHONPATH=src python3 -m repro_torch.profile_train --streams

Trains an 8-tree SyD10M9A forest (10,000,000 cases, 256 bins, seed 0;
``ensemble.train_forest`` with ``impl="frontier"``, the CUDA kernels, and
the grow configuration ``repro_torch.configs.yadt.WORKLOAD.grow``) on 1, 2
and 4 farm workers, in turns (1, 2, 4, 4, 2, 1), each forest equal to the
first; ``--streams`` adds two runs on 4 workers with each tree task on a
CUDA stream of its own.  Then grows census_pums (128 bins) at scales 0.02,
0.1 and 1.0 with the c45 oracle on the card (wall time, nodes, time a
node) beside the CUDA frontier build of the same data, and, at 0.02 and
0.1, through ``farm_build.build`` on 1 and 4 workers and on 4 under the
smoke's chaos (crash_p 0.2, worker 1 dead).  Every tree is held to the
oracle's.  One JSON line a measurement, the card's name and power limit
first; the host clock around each call, the card waited for.
"""

from __future__ import annotations

import json
import time

SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
FOREST_TREES = 8
WORKER_TURNS = (1, 2, 4, 4, 2, 1)
CENSUS_BINS = 128
CENSUS_SCALES = (0.02, 0.1, 1.0)
FARM_SCALES = (0.02, 0.1)


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def _on_own_stream(train_tree):
    """``train_tree`` with each call on a CUDA stream of its own."""
    import torch

    def streamed(*args, **kw):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            tree = train_tree(*args, **kw)
        stream.synchronize()
        return tree
    return streamed


def forests(streams: bool) -> None:
    from repro_torch.configs.yadt import WORKLOAD
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import quest
    from repro_torch.ensemble import trainer

    syd = quest.syd(SYD_CASES, seed=SYD_SEED, max_bins=SYD_BINS)
    fc = trainer.ForestConfig(n_trees=FOREST_TREES, seed=SYD_SEED,
                              grow=WORKLOAD.grow)
    runs = [(n, False) for n in WORKER_TURNS]
    if streams:
        runs += [(4, True), (4, True)]
    first = None
    plain = trainer.train_tree
    for workers, own_streams in runs:
        trainer.train_tree = _on_own_stream(plain) if own_streams else plain
        try:
            res, wall = _timed(lambda: trainer.train_forest(
                syd, fc, impl="frontier", n_workers=workers))
        finally:
            trainer.train_tree = plain
        first = first or res.trees
        same = all(trees_equal(a, b) for a, b in zip(res.trees, first))
        _emit(forest="syd10m9a", trees=FOREST_TREES, workers=workers,
              stream_per_tree=own_streams, wall_s=wall,
              trees_per_s=FOREST_TREES / wall,
              worker_busy_s=res.stats["worker_busy"],
              worker_tasks=res.stats["worker_tasks"], equal=same)


def builds() -> None:
    from repro_torch.configs.yadt import WORKLOAD
    from repro_torch.core import c45, faults, farm_build, frontier
    from repro_torch.core.farm import FaultPolicy
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets

    cfg = WORKLOAD.grow
    for scale in CENSUS_SCALES:
        ds = datasets.load("census_pums", scale=scale, max_bins=CENSUS_BINS)
        tree, frontier_s = _timed(lambda: frontier.build(ds, cfg))
        trace = []
        oracle, c45_s = _timed(lambda: c45.build(ds, cfg,
                                                 task_trace=trace))
        _emit(dataset="census_pums", scale=scale, cases=ds.n_cases,
              nodes=oracle.size,
              split_nodes=sum(1 for t in trace if t["n_children"]),
              c45_s=c45_s, c45_ms_a_node=c45_s / oracle.size * 1e3,
              frontier_cuda_s=frontier_s, equal=trees_equal(oracle, tree))
        if scale not in FARM_SCALES:
            continue
        for workers, chaos in ((1, False), (4, False), (4, True)):
            inj = faults.FaultInjector(seed=7, spec=faults.FaultSpec(
                crash_p=0.2, dead_workers=frozenset({1})),
                key_fn=lambda t: t.node_id) if chaos else None
            stats = {}
            farm_tree, farm_s = _timed(lambda: farm_build.build(
                ds, cfg, n_workers=workers, injector=inj,
                fault=FaultPolicy(max_retries=8, seed=3, backoff_base=1e-4),
                stats_out=stats))
            _emit(dataset="census_pums", scale=scale, farm_workers=workers,
                  chaos=chaos, farm_s=farm_s, per_c45=farm_s / c45_s,
                  failures=stats["failures"],
                  worker_tasks=stats["worker_tasks"],
                  equal=trees_equal(farm_tree, oracle))


def main(argv=None) -> int:
    import argparse
    import subprocess

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", action="store_true",
                    help="also train on 4 workers with a stream a tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    _emit(card=card)
    forests(args.streams)
    builds()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
