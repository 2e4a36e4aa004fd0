"""Device profile of the forest traversal on the GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_infer
    PYTHONPATH=src python3 -m repro_torch.profile_infer --against OTHER/src
    PYTHONPATH=src python3 -m repro_torch.profile_infer --variants

Grows the forest of ``chip_smoke.py``'s phase 5 once (16 members on
SyD10M9A, 10,000,000 cases, through the ensemble trainer's sequential
per-tree oracle, packed at M = 2^18) and a 4-tree census_pums forest
(A = 40), and saves both with
their cases under ``build/profile_infer/``.  Then, in a process of its own
for each port profiled (with ``--against``, the port of another checkout
and this one in turns: against, this, this, against, on one card), it
times the traversal kernel in each regime of the plan: N = 10M and the
serving batch N = 1,024 of the SyD forest, the census forest over its
299,285 cases, and 70,000 small trees (lone leaves, depth 1 and 2) over
1,024 cases; each beside its bound
and the plan taken (an earlier port: its threads; the 70,000 trees only
where the port's grid takes them), and where the SyD walks' steps fall
(the share at node rows below 256 and 8,192).  And it splits ``predict()``
at N = 10M into the host-to-device copy of the rows, the kernel and the
vote.  ``--variants`` also times this port's kernel with each block size
pinned at N = 10M and 1,024.  Kernel times are CUDA events around
back-to-back launches queued behind a spin of the card (the host's launch
cost stays outside).  One JSON line a run; it checks no result
(``chip_smoke.py`` holds the kernel to its plain version).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path


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

SYD_CASES = 10_000_000
SYD_BINS = 256
SYD_SEED = 0
CENSUS_SCALE = 1.0
CENSUS_BINS = 128
FOREST_TREES = 16
FOREST_SEED = 0
CENSUS_FOREST_TREES = 4
SERVE_BATCH = 1024
SMALL_TREES = 70_000
SMALL_SEED = 0
# block sizes pinned by --variants, at N = 10M and at the serving batch
VARIANTS = [(block_n, n) for n in (SYD_CASES, SERVE_BATCH)
            for block_n in (32, 64, 128, 256, 512, 1024)]
# the step shares reported: steps taken at node rows below these
STEP_ROWS = (256, 8192)
# spin cycles a queued call (about 0.2 ms at the H100's clocks): several
# times what the host takes to queue one forest_predict call (a quarter of
# this let the host's pace show in one reading of the serving batch)
SPIN_CYCLES_PER_CALL = 400_000


def grow_forest(ds, cfg, n_trees):
    """The trainer's sequential per-tree oracle: ``n_trees`` members
    (seed FOREST_SEED, bootstrap, mtry ceil(sqrt(A)), grow ``cfg``), each
    through the frontier build with the CUDA kernels."""
    from repro_torch.ensemble import trainer
    fc = trainer.ForestConfig(n_trees=n_trees, seed=FOREST_SEED, grow=cfg)
    return trainer.train_forest_sequential(ds, fc, impl="frontier")


def small_trees(n_trees: int, n_attrs: int, *, seed: int, n_bins: int,
                n_classes: int = 2):
    """(T, 7, 8) int32 node table of random small trees, a third each lone
    leaves, one split and two levels of splits (breadth-first, binary, any
    attribute: a discrete one's bin is clipped to the two children), and
    the descent depth that reaches every leaf."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tab = np.zeros((n_trees, 7, 8), np.int32)
    tab[..., :2] = -1
    tab[..., 5] = rng.integers(0, n_classes, (n_trees, 7))
    kind = rng.integers(0, 3, n_trees)
    for row, child0, trees in ((0, 1, kind >= 1), (1, 3, kind == 2),
                               (2, 5, kind == 2)):
        k = int(trees.sum())
        tab[trees, row, :5] = np.stack([
            rng.integers(0, n_attrs, k), rng.integers(0, n_bins, k),
            np.full(k, child0), np.full(k, 2), rng.integers(0, 2, k)], 1)
    return tab, 3


def traversal_bound(tab, x, cont, max_depth: int) -> dict:
    """The least time of one traversal on the H100: bytes, the rows, the
    distinct (tree, node) table rows their walks visit (the nodes they end
    at and those nodes' ancestors, 32 bytes each) and the labels once each;
    operations, ``roofline.OPS_PER_STEP`` a descent step this data takes (each walk's
    final depth) at the scalar peak.  Walks the plain version once with
    each node's row id in the class column."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.tree_infer import COL_CHILD0, COL_CLASS, \
        COL_NCHILD
    t_dim, m_dim, _ = tab.shape
    n, a_dim = x.shape
    dev = tab.device
    ids = tab.clone()
    ids[..., COL_CLASS] = torch.arange(m_dim, dtype=torch.int32, device=dev)
    ends = ref.forest_predict_ref(ids, x, cont, max_depth=max_depth).long()
    del ids
    nchild = tab[..., COL_NCHILD].reshape(-1).long().clamp_min(0)
    row = torch.arange(t_dim * m_dim, device=dev)
    node = row.repeat_interleave(nchild)
    rank = (torch.arange(node.numel(), device=dev)
            - (torch.cumsum(nchild, 0) - nchild).repeat_interleave(nchild))
    child = (node // m_dim * m_dim + rank + tab[..., COL_CHILD0].reshape(-1)
             .long().repeat_interleave(nchild))
    parent = torch.full((t_dim * m_dim,), -1, dtype=torch.int64, device=dev)
    parent[child] = node
    depth = torch.zeros(t_dim * m_dim, dtype=torch.int64, device=dev)
    flat = (ends + torch.arange(t_dim, device=dev)[:, None] * m_dim
            ).reshape(-1)
    seen = torch.zeros(t_dim * m_dim, dtype=torch.bool, device=dev)
    seen[flat] = True
    for _ in range(max_depth):
        depth[child] = depth[node] + 1
        up = parent[seen]
        seen[up[up >= 0]] = True
    steps = int(depth[flat].sum())
    rows = int(seen.sum())
    # steps taken from each row: the walks through it less those ending
    # there, the walks through a row summed up from the deepest level
    through = torch.bincount(flat, minlength=t_dim * m_dim)
    ends_at = through.clone()
    has_parent = parent >= 0
    for d in range(max_depth, 0, -1):
        level = has_parent & (depth == d)
        through.index_add_(0, parent[level], through[level])
    from_row = (through - ends_at).reshape(t_dim, m_dim)
    below = {r: float(from_row[:, :r].sum()) / max(steps, 1)
             for r in STEP_ROWS}
    n_bytes = roofline.traversal_bytes(n, a_dim, t_dim, rows)
    t_bytes = roofline.bound_ms(n_bytes, 0)[0]
    t_ops = roofline.bound_ms(0, roofline.traversal_ops(steps))[0]
    bound_ms, bound_by = roofline.bound_ms(n_bytes,
                                           roofline.traversal_ops(steps))
    return dict(steps=steps, steps_below_row=below, rows_visited=rows,
                bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
                bytes_ms=t_bytes, operations_ms=t_ops)


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, queued behind a spin of the card so that the host's
    launch cost does not show (``fn`` must launch only the timed work)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * SPIN_CYCLES_PER_CALL)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _plan(n, t, block_n=None):
    """The plan this port takes (an earlier port's: its threads)."""
    from repro_torch.kernels import autotune
    if "mode" not in autotune.InferPlan.__dataclass_fields__:
        return dataclasses.asdict(autotune.plan_infer_blocks(n_cases=n))
    return dataclasses.asdict(autotune.plan_infer_blocks(
        n_cases=n, n_trees=t, block_n=block_n))


def _ms(tab, x, cont, depth, reps: int, block_n=None) -> float:
    from repro_torch.kernels import tree_infer
    return device_ms(lambda: tree_infer.forest_predict(
        tab, x, cont, max_depth=depth, block_n=block_n), reps)


def predict_split(fo, x_np, cont_np, reps: int = 3) -> list[dict]:
    """``predict()`` from host rows to labels on the card (host clock,
    synchronised), and its parts as it runs them: the rows' copy to the
    card (host clock), the per-tree kernel and the vote (CUDA events)."""
    import torch

    from repro_torch.infer import forest as F
    dev = fo.device
    cont = torch.as_tensor(cont_np).to(dev)
    F.predict(fo, x_np, cont_np)
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F.predict(fo, x_np, cont_np)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = torch.as_tensor(x_np, dtype=torch.int32).to(dev).contiguous()
        torch.cuda.synchronize()
        copy = time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        per_tree = F.predict_per_tree(fo, x, cont)
        ev[1].record()
        F.vote(per_tree, fo.tree_weight, n_classes=fo.n_classes)
        ev[2].record()
        ev[2].synchronize()
        runs.append(dict(predict_ms=total * 1e3, copy_ms=copy * 1e3,
                         kernel_ms=ev[0].elapsed_time(ev[1]),
                         vote_ms=ev[1].elapsed_time(ev[2])))
        del x, per_tree
    return runs


def profile(data: Path, variants: bool) -> dict:
    import numpy as np
    import torch

    from repro_torch.infer import forest as F
    from repro_torch.kernels import tree_infer

    dev = torch.device("cuda")
    fo = F.forest_from_numpy(np.load(data / "syd_forest.npz"), dev)
    c_fo = F.forest_from_numpy(np.load(data / "census_forest.npz"), dev)
    x_np = np.load(data / "syd_x.npy")
    meta = json.loads((data / "meta.json").read_text())
    x = torch.as_tensor(x_np).to(dev)
    cont = torch.as_tensor(np.asarray(meta["syd_cont"], bool)).to(dev)
    c_x = torch.as_tensor(np.load(data / "census_x.npy")).to(dev)
    c_cont = torch.as_tensor(np.asarray(meta["census_cont"], bool)).to(dev)
    tab, depth = fo.node_table(), fo.n_levels
    small, small_depth = small_trees(SMALL_TREES, x.shape[1],
                                     seed=SMALL_SEED, n_bins=SYD_BINS)
    small = torch.as_tensor(small).to(dev)
    batch = x[:SERVE_BATCH].contiguous()
    regimes = [("syd N=10M", tab, x, cont, depth, 5),
               ("syd N=1024", tab, batch, cont, depth, 200),
               ("census_pums", c_fo.node_table(), c_x, c_cont,
                c_fo.n_levels, 10)]
    if hasattr(tree_infer, "PLANS"):       # a grid without T <= 65,535
        regimes.append((f"T={SMALL_TREES} small trees N=1024", small, batch,
                        cont, small_depth, 50))
    out = dict(regimes=[])
    for name, t_, x_, c_, d_, reps in regimes:
        t_dim, m_dim, _ = t_.shape
        out["regimes"].append(dict(
            regime=name, T=t_dim, M=m_dim, N=x_.shape[0], A=x_.shape[1],
            depth=d_, kernel_ms=_ms(t_, x_, c_, d_, reps),
            plan=_plan(x_.shape[0], t_dim),
            **traversal_bound(t_, x_, c_, d_)))
    if variants:
        out["variants"] = [
            dict(block_n=block_n, N=n, plan=_plan(n, tab.shape[0], block_n),
                 kernel_ms=_ms(tab, x[:n].contiguous(), cont, depth,
                               5 if n == SYD_CASES else 200, block_n))
            for block_n, n in VARIANTS]
    del x, batch, small
    torch.cuda.empty_cache()
    out["predict_10M"] = predict_split(fo, x_np, np.asarray(meta["syd_cont"],
                                                            bool))
    return out


def prepare(data: Path) -> None:
    """Grow and save the two forests and their cases (once a profile)."""
    import numpy as np
    import torch

    from repro_torch.configs.yadt import WORKLOAD
    from repro_torch.data import datasets, quest
    from repro_torch.infer import forest as F

    data.mkdir(parents=True, exist_ok=True)
    cfg = WORKLOAD.grow
    syd = quest.syd(SYD_CASES, seed=SYD_SEED, max_bins=SYD_BINS)
    census = datasets.load("census_pums", scale=CENSUS_SCALE,
                           max_bins=CENSUS_BINS)
    for name, ds, n_trees, cap in (
            ("syd", syd, FOREST_TREES, cfg.max_nodes),
            ("census", census, CENSUS_FOREST_TREES, None)):
        fo = F.Forest.pack(grow_forest(ds, cfg, n_trees), capacity=cap,
                           device=torch.device("cuda"))
        np.savez(data / f"{name}_forest.npz", **fo.to_numpy())
        np.save(data / f"{name}_x.npy", np.ascontiguousarray(ds.x))
    (data / "meta.json").write_text(json.dumps(dict(
        syd_cont=np.asarray(syd.attr_is_cont).tolist(),
        census_cont=np.asarray(census.attr_is_cont).tolist())))


def main(argv=None) -> int:
    import argparse
    import subprocess
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="profile the repro_torch package in this "
                    "directory (run this file by its path for it)")
    ap.add_argument("--data", help="the saved forests (made if missing)")
    ap.add_argument("--against", help="the src directory of another "
                    "checkout: profile it and this one in turns")
    ap.add_argument("--variants", action="store_true",
                    help="also time this port with each block size pinned")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parents[1])
    data = Path(args.data or Path(here).parent / "build" / "profile_infer")
    if args.src:
        sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the profile needs a GPU")
    if not args.src:
        if not (data / "meta.json").exists():
            prepare(data)
        runs = [("this", here)]
        if args.against:
            runs = [("against", args.against), ("this", here),
                    ("this", here), ("against", args.against)]
        for label, src in runs:
            cmd = [sys.executable, __file__, "--src", src, "--data",
                   str(data)]
            if args.variants and label == "this":
                cmd.append("--variants")
            res = subprocess.run(cmd, capture_output=True, text=True)
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
    print(json.dumps({"card": card,
                      "profile": profile(data, args.variants)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
