"""Farm-parallel random-forest training: one farm task per tree.

The paper parallelises *within* one C4.5 build (nodes/attributes streams);
an ensemble adds the natural outer level — whole trees as independent tasks.
This trainer dispatches T tree tasks over the supervised
:class:`repro_torch.core.farm.Farm`, as the JAX package's
``ensemble.trainer``:

  * a **tree task** is pure: the worker regenerates its bootstrap weights
    and feature subset from ``(seed, tree_id)`` (:mod:`.sampling`) and grows
    the tree with the shared dataset — so the farm's retry / quarantine /
    worker-death re-dispatch semantics are inherited unchanged, and a chaos
    run produces the exact same forest as the sequential per-tree oracle
    (:func:`train_forest_sequential`);
  * trees are collected by ``tree_id``, so completion order (and hence
    worker count, scheduling, injected faults) cannot reorder the forest;
  * ``impl="c45"`` grows each tree with the sequential oracle engine;
    ``impl="frontier"`` with :func:`repro_torch.core.frontier.build`, whose
    ``kernel_impl`` (None: ``"cuda"``, the histogram and split-gain kernels,
    on a CUDA device and ``"torch"`` on the CPU) is the splitAtt path, with
    the per-tree feature mask and bootstrap weights as its hooks.

Every build runs on ``device`` (None: the card; raises without one).  The
farm's workers are threads: with ``n_workers > 1`` several builds launch
their kernels at once, on one stream.

A tree that exhausts its retry budget is quarantined; ``strict=True``
(default) raises :class:`QuarantinedTrees`, otherwise the forest is returned
without it (recorded in ``TrainResult.quarantined``).  A worker's exception
(a failed launch included) is such a failure: retried, never swallowed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch.core import c45, frontier
from repro_torch.core.binning import BinnedDataset
from repro_torch.core.config import GrowConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.farm import Farm, FaultPolicy, TaskFailure
from repro_torch.core.scheduler import Policy
from repro_torch.core.tree import Tree
from repro_torch.ensemble import sampling
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

IMPLS = ("c45", "frontier")


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Ensemble-level knobs; ``grow`` is the shared per-tree GrowConfig.

    ``mtry=None`` uses :func:`repro_torch.ensemble.sampling.default_mtry`
    (ceil(sqrt(A))); ``bootstrap=False`` disables resampling (every tree
    sees the full weights — pure feature-subspace bagging, no OOB).
    """

    n_trees: int = 8
    seed: int = 0
    mtry: int | None = None
    bootstrap: bool = True
    grow: GrowConfig = dataclasses.field(default_factory=GrowConfig)

    def resolved_mtry(self, n_attrs: int) -> int:
        return self.mtry if self.mtry is not None \
            else sampling.default_mtry(n_attrs)

    def sample(self, ds: BinnedDataset, tree_id: int) -> sampling.TreeSample:
        return sampling.draw(self.seed, tree_id, n_cases=ds.n_cases,
                             n_attrs=ds.n_attrs, base_w=ds.w, mtry=self.mtry,
                             bootstrap=self.bootstrap)


class QuarantinedTrees(RuntimeError):
    """Raised under ``strict=True`` when tree tasks exhausted their retries."""

    def __init__(self, failures: list[TaskFailure]):
        self.failures = failures
        ids = [f.payload for f in failures]
        super().__init__(f"{len(failures)} tree task(s) quarantined: {ids}")


@dataclasses.dataclass
class TrainResult:
    """Ordered forest + execution breakdown of one training run."""

    trees: list[Tree]           # ascending tree_id, quarantined ids omitted
    tree_ids: list[int]
    config: ForestConfig
    stats: dict[str, Any]       # Farm.stats() + wall_s / trees_per_s
    quarantined: list[int]

    @property
    def n_trees(self) -> int:
        return len(self.trees)


def train_tree(ds: BinnedDataset, fc: ForestConfig, tree_id: int, *,
               impl: str = "c45", kernel_impl: str | None = None,
               device=None) -> Tree:
    """Grow forest member ``tree_id``: a pure function of (ds, fc, tree_id).

    Shared verbatim by the farm workers and the sequential oracle, so both
    paths make identical trees for a given ``(seed, tree_id)``.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    s = fc.sample(ds, tree_id)
    if impl == "c45":
        return c45.build(ds, fc.grow, device=device, attr_mask=s.attr_mask,
                         case_w=s.case_w)
    return frontier.build(ds, fc.grow, impl=kernel_impl, device=device,
                          attr_mask=s.attr_mask, case_w=s.case_w)


def train_forest_sequential(ds: BinnedDataset, fc: ForestConfig, *,
                            impl: str = "c45",
                            kernel_impl: str | None = None,
                            device=None) -> list[Tree]:
    """The per-tree oracle every farm run must reproduce exactly."""
    dev = resolve_device(device)
    return [train_tree(ds, fc, t, impl=impl, kernel_impl=kernel_impl,
                       device=dev)
            for t in range(fc.n_trees)]


def train_forest(ds: BinnedDataset, fc: ForestConfig, *,
                 impl: str = "c45", kernel_impl: str | None = None,
                 device=None, n_workers: int = 4,
                 policy: Policy | None = None,
                 fault: FaultPolicy | None = None, injector: Any = None,
                 strict: bool = True, stats_out: dict | None = None,
                 tracer: obs_trace.Tracer | None = None,
                 metrics: obs_metrics.Registry | None = None) -> TrainResult:
    """Train the forest through the supervised farm; oracle-equal result.

    One farm task per tree (weight = N cases, the WS weight of a full
    build); the worker service is pure, so the farm may retry / re-dispatch
    tree tasks on crashes, hangs and worker deaths without changing the
    forest.  ``injector`` wraps the tree service with
    :class:`repro_torch.core.faults.FaultInjector` for chaos runs.
    """
    dev = resolve_device(device)
    tracer = tracer if tracer is not None else obs_trace.NULL
    reg = metrics if metrics is not None else obs_metrics.REGISTRY
    m_trees = reg.counter("ensemble_trees_trained_total",
                          "forest members grown, by impl= label")
    m_tree_s = reg.histogram("ensemble_tree_seconds",
                             "wall time per tree task attempt")
    m_rate = reg.gauge("ensemble_trees_per_s",
                       "trees/sec of the last train_forest run")

    done: dict[int, Tree] = {}
    quarantined: list[TaskFailure] = []

    def emitter(task: Any, send) -> None:
        if task is None:                     # start-up: the whole forest
            for tid in range(fc.n_trees):
                send(tid, weight=float(max(ds.n_cases, 1)))
            return
        if isinstance(task, TaskFailure):    # tree exhausted its retries
            quarantined.append(task)
            return
        tid, tree = task
        done[tid] = tree

    def worker(tid: int):
        t0 = time.perf_counter()
        with tracer.span("ensemble.tree", tree=tid, impl=impl):
            tree = train_tree(ds, fc, tid, impl=impl,
                              kernel_impl=kernel_impl, device=dev)
        m_tree_s.observe(time.perf_counter() - t0)
        m_trees.inc(impl=impl)
        return tid, tree

    farm = Farm(n_workers, policy=policy, fault=fault, tracer=tracer,
                metrics=reg)
    svc = injector.wrap_worker(worker) if injector is not None else worker
    t0 = time.perf_counter()
    stats = dict(farm.run(emitter, svc))
    wall = time.perf_counter() - t0
    stats["wall_s"] = wall
    stats["trees_per_s"] = len(done) / wall if wall > 0 else float("inf")
    m_rate.set(stats["trees_per_s"], impl=impl)
    if stats_out is not None:
        stats_out.update(stats)
    if strict and quarantined:
        raise QuarantinedTrees(quarantined)
    ids = sorted(done)
    return TrainResult(
        trees=[done[t] for t in ids], tree_ids=ids, config=fc, stats=stats,
        quarantined=sorted(int(f.payload) for f in quarantined))
