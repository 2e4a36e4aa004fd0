"""One run of one cell: set-up, the measured window, the check, the line.

Set-up makes the cell's inputs on the device: the configuration's cases
(its generator, from its ``data_seed``) in the order ``seed`` draws, so
that every seed asks for the same work.  It hands them to the host as the
``BinnedDataset`` a user would pass, and grows one
warm-up tree of the cell's own shape (the kernels load, or build on a
checkout's first run, and the allocator fills).  The window then grows
whole trees back to back through ``repro_torch.core.frontier.build`` with
one caller, each from the host dataset, so that each build copies the
rows to the card; it ends at the first tree boundary at or after
``seconds``.  After it, every tree built is held to the plain reference,
and so is one more tree, grown through the same build on inputs drawn
from ``seed`` itself, so that each seed also checks another data set.

With ``trace`` the window runs under the program's ``Tracer`` (its
``superstep`` and phase spans, beside the harness's own ``tree`` span a
build), and the run reports the per-layer metrics instead of the
end-to-end ones.  Its first half is traced by the ``Tracer`` alone: the
span metrics and ``build_mfu`` read those trees.  From the first tree
boundary past half of ``seconds`` ``torch.profiler`` records the card's
activity as well (its cost falls on every launch, so it would slow the
spans): the rooflines and the idle share read those trees.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from bench import reference, spec, trace, work
from bench.dataset import Data, permuted

# the comparison that decides ``correct``: nodes of a tree that differ from
# the reference's, and its limit (an exact comparison)
MISMATCH_LIMIT = 0


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: str
    setup_s: float
    window_s: float
    tree_s: list[float]
    peak_bytes: int
    work: work.Work
    # traced: the spans of the trees traced by the Tracer alone, and the
    # card's activity over the trees traced by the profiler too
    spans: dict[str, list[tuple[int, int]]] | None = None
    span_trees: int = 0
    device: trace.DeviceTrace | None = None
    device_trees: int = 0

    @property
    def n_trees(self) -> int:
        return len(self.tree_s)

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans.get(name, ())) / 1e9


def dataset(data: Data):
    """The inputs as the host ``BinnedDataset`` the port takes."""
    from repro_torch.core.binning import BinnedDataset
    return BinnedDataset(
        x=data.x.cpu().numpy(), y=data.y.to(torch.int32).cpu().numpy(),
        w=np.ones(data.n_cases, np.float32),
        attr_is_cont=np.asarray(data.attr_is_cont, bool),
        n_bins=np.asarray(data.n_bins, np.int32),
        bin_edges=tuple(e.numpy() for e in data.bin_edges),
        n_classes=data.n_classes, attr_names=tuple(data.attr_names))


def port_builder(grow: dict, device: str) -> Callable:
    """``build(ds, tracer)`` through the port's main path."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.obs.metrics import Registry
    cfg = GrowConfig(**grow)
    impl = "cuda" if torch.device(device).type == "cuda" else "torch"

    def build(ds, tracer=None):
        return frontier.build(ds, cfg, impl=impl, device=device,
                              tracer=tracer,
                              metrics=Registry() if tracer else None)
    return build


def host_tree(tree) -> dict[str, np.ndarray]:
    n = int(tree.n_nodes)
    return {f: getattr(tree, f)[:n].cpu().numpy() for f in reference.FIELDS}


def digest(tree: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for f in reference.FIELDS:
        h.update(np.ascontiguousarray(tree[f]).tobytes())
    return h.hexdigest()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _spans(tracer, first_ns: int, clock_offset: int
           ) -> dict[str, list[tuple[int, int]]]:
    """The tracer's spans by name, in Unix nanoseconds.  The tracer's clock
    starts at its own epoch: its first ``tree`` span opened at
    ``first_ns`` (``perf_counter_ns``, within microseconds)."""
    events = [ev for ev in tracer.events if ev.get("ph") == "X"]
    first_tree = min(ev["ts"] for ev in events if ev["name"] == "tree")
    base = first_ns - int(first_tree * 1e3) + clock_offset
    spans: dict[str, list[tuple[int, int]]] = {}
    for ev in events:
        s = base + int(ev["ts"] * 1e3)
        spans.setdefault(ev["name"], []).append((s, s + int(ev["dur"] * 1e3)))
    return spans


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


@dataclasses.dataclass
class Check:
    """The trees of a run held to the reference."""
    mismatched: int = 0         # the most nodes one tree got wrong
    failed: int = 0             # trees with more than the limit
    near_ties: int = 0
    tie_share: float = 0.0
    judged: reference.Result | None = None

    def add(self, tested: dict[str, np.ndarray], ref: reference.Result,
            n_trees: int = 1) -> int:
        bad = reference.compare(tested, ref.tree)
        self.mismatched = max(self.mismatched, bad)
        self.failed += n_trees if bad > MISMATCH_LIMIT else 0
        self.near_ties += ref.near_ties
        self.tie_share = max(self.tie_share, ref.tie_share)
        self.judged = self.judged or ref
        return bad


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start: float | None = None,
             config: dict | None = None, build: Callable | None = None,
             log=print) -> dict:
    """Run ``cell`` once; returns the result line's fields and the numbers
    compared (``compared``).  ``config`` and ``build`` replace the cell's
    configuration file and the port's build (the harness's tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    config = spec.config(cell.config) if config is None else config
    mix = spec.traffic(cell.traffic)
    grow = {**config["grow"], **mix.get("grow", {})}
    cuda = torch.device(device).type == "cuda"
    gen = spec.generator(config["generator"])

    t_gen = time.perf_counter()
    data = permuted(gen.generate(config, config["data_seed"], device), seed)
    ds = dataset(data)
    _sync(device)
    t_gen = time.perf_counter() - t_gen
    x_host, y_host = ds.x, data.y.cpu().numpy()
    shape = dict(n_bins=list(data.n_bins), attr_is_cont=data.attr_is_cont,
                 n_classes=data.n_classes)
    del data
    if cuda:
        torch.cuda.empty_cache()
    build = port_builder(grow, device) if build is None else build
    # warm-up: the cell's own shape, through the path the window takes
    # (traced: under the Tracer and the profiler, which starts up here)
    t_warm = time.perf_counter()
    if trace_on:
        from repro_torch.obs.trace import Tracer
        if cuda:
            with _profiler():
                build(ds, Tracer())
                _sync(device)
        else:
            build(ds, Tracer())
    else:
        build(ds)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: inputs made {t_gen:.3f} s, warm-up tree "
        f"{time.perf_counter() - t_warm:.3f} s")

    # ---- the window
    tracers = [Tracer()] if trace_on else [None]
    first_ns = []           # a tracer's first tree, perf_counter_ns
    prof = p0 = None
    profiled_from = None    # the first tree traced by the profiler
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    clock_offset = time.time_ns() - time.perf_counter_ns()
    trees, tree_s = [], []
    w0 = time.perf_counter()
    while True:
        if (trace_on and cuda and prof is None and trees
                and time.perf_counter() - w0 >= seconds / 2):
            tracers.append(Tracer())
            profiled_from = len(trees)
            p0 = time.perf_counter()
            prof = _profiler()
            prof.__enter__()
        tracer = tracers[-1]
        t0 = time.perf_counter()
        if tracer is not None:
            if len(first_ns) < len(tracers):
                first_ns.append(time.perf_counter_ns())
            with tracer.span("tree"):
                tree = build(ds, tracer)
                _sync(device)
        else:
            tree = build(ds)
            _sync(device)
        tree_s.append(time.perf_counter() - t0)
        trees.append(host_tree(tree))
        del tree
        if (time.perf_counter() - w0 >= seconds
                and (prof is not None or not (trace_on and cuda))):
            break
    w1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ops = []
    if prof is not None:
        prof.__exit__(None, None, None)
        ops = trace.device_ops(prof)
        del prof

    # ---- the check: every tree built against the reference
    if cuda:
        torch.cuda.empty_cache()
    g = reference.Grow.of(grow)
    x = torch.as_tensor(x_host, device=device)
    y = torch.as_tensor(y_host, device=device)
    by_digest: dict[str, list[int]] = {}
    for i, t in enumerate(trees):
        by_digest.setdefault(digest(t), []).append(i)
    check = Check()
    t_ref = time.perf_counter()
    for idx in by_digest.values():
        tested = trees[idx[0]]
        check.add(tested, reference.grow(x, y, grow=g, tested=tested,
                                         **shape), len(idx))
    window_bad = check.mismatched
    log(f"reference: {len(by_digest)} distinct tree(s) of {len(trees)}, "
        f"{time.perf_counter() - t_ref:.1f} s, {check.near_ties} near ties "
        f"(the farthest at {check.tie_share:.3g} of its tolerance), "
        f"{len(trees[0]['node_attr'])} nodes")
    del x, y

    # ---- and a tree on inputs drawn from the seed, through the same build
    t_seed = time.perf_counter()
    data = gen.generate(config, seed, device)
    tested = host_tree(build(dataset(data)))
    _sync(device)
    seed_bad = check.add(tested, reference.grow(
        data.x, data.y, grow=g, tested=tested, n_bins=list(data.n_bins),
        attr_is_cont=data.attr_is_cont, n_classes=data.n_classes))
    log(f"the seed's own inputs: {len(tested['node_attr'])} nodes, "
        f"{seed_bad} mismatched, {time.perf_counter() - t_seed:.1f} s")
    del data, tested

    run = Run(cell=cell.name, setup_s=setup_s,
              window_s=w1 - w0, tree_s=tree_s, peak_bytes=peak,
              work=work.of_reference(check.judged, n_attrs=x_host.shape[1],
                                     n_classes=shape["n_classes"]))
    out = dict(correct=check.failed == 0, attempted=len(trees) + 1,
               failed=check.failed)
    if trace_on:
        run.spans = _spans(tracers[0], first_ns[0], clock_offset)
        run.span_trees = (len(trees) if profiled_from is None
                          else profiled_from)
        if profiled_from is not None:
            run.device_trees = len(trees) - profiled_from
            run.device = trace.reduce(
                ops, (int(p0 * 1e9) + clock_offset,
                      int(w1 * 1e9) + clock_offset),
                _spans(tracers[1], first_ns[1], clock_offset))
    out["run"] = run
    out["compared"] = {
        "mismatched_nodes": {"value": window_bad, "limit": MISMATCH_LIMIT},
        "mismatched_nodes_seed_data": {"value": seed_bad,
                                       "limit": MISMATCH_LIMIT}}
    return out


def metrics(spec_: spec.Spec, run: Run, *, trace_on: bool) -> dict:
    """The cell's metrics by their readers; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for m in spec_.metrics_of(run.cell, trace=trace_on):
        value = spec.reader(m.name).read(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
