"""C4.5 tree growth through the supervised threaded farm (paper Fig. 5).

This is the paper's actual deployment shape — ``ff_farm<ws_scheduler>`` with
the emitter feeding node tasks to workers over the feedback channel — run on
the fault-tolerant :class:`repro_torch.core.farm.Farm`, as the JAX
package's ``core.farm_build``:

  * **workers** execute :func:`repro_torch.core.c45.split_node`, a *pure*
    function of (dataset, task), on the build's device.  Attempts are
    therefore idempotent: the supervisor may re-run a crashed/hung/lost
    task on any surviving worker without corrupting the build;
  * the **emitter** owns the node table and applies split decisions
    strictly in task-emission (= breadth-first) order, buffering
    out-of-order completions.  Child node ids are thus assigned in exactly
    the sequential oracle's BFS order no matter how the farm interleaves —
    trees are elementwise-comparable (``trees_equal``) even under injected
    crashes, worker deaths and retries.

A task that exhausts its :class:`~repro_torch.core.farm.FaultPolicy` retry
budget is quarantined; its node degrades to a leaf (the tree stays valid)
and ``strict=True`` (default) raises so silent truncation cannot pass for
success.  A worker's exception (a failed launch included) is a task
failure like any other: retried, then quarantined.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core import c45
from repro_torch.core.binning import BinnedDataset
from repro_torch.core.config import GrowConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.farm import Farm, FaultPolicy, TaskFailure
from repro_torch.core.scheduler import Policy
from repro_torch.core.tree import Tree


@dataclasses.dataclass
class NodeTask:
    """One farm task = one open node (weight = r cases, the WS weight)."""

    node_id: int
    idx: torch.Tensor
    w: torch.Tensor
    active: np.ndarray
    depth: int
    cls: int
    freq: np.ndarray


class QuarantinedNodes(RuntimeError):
    """Raised under ``strict=True`` when node tasks exhausted their retries."""

    def __init__(self, failures: list[TaskFailure]):
        self.failures = failures
        ids = [f.payload.node_id for f in failures]
        super().__init__(f"{len(failures)} node task(s) quarantined: {ids}")


def build(ds: BinnedDataset, cfg: GrowConfig = GrowConfig(), *,
          n_workers: int = 4, policy: Policy | None = None,
          fault: FaultPolicy | None = None, injector: Any = None,
          capacity: int | None = None, strict: bool = True,
          stats_out: dict | None = None, tracer: Any = None,
          metrics: Any = None, attr_mask=None, case_w=None,
          device=None) -> Tree:
    """Grow a C4.5 tree through the supervised farm; oracle-equal result.

    ``device``    — where the nodes' cases live and split (None: the card;
                    raises without one).
    ``injector``  — optional :class:`repro_torch.core.faults.FaultInjector`;
                    its ``wrap_worker`` is applied to the node-split service.
    ``stats_out`` — optional dict filled with the farm's execution + failure
                    breakdown (``Farm.stats()``).
    ``tracer`` / ``metrics`` — optional :class:`repro_torch.obs.trace.Tracer`
                    / :class:`repro_torch.obs.metrics.Registry`; the farm
                    records task spans, retry/quarantine/death events and
                    queued-weight timelines into them.
    ``attr_mask`` / ``case_w`` — same per-tree feature-subset / bootstrap
                    weight hooks as :func:`repro_torch.core.c45.build`.
    """
    dev = resolve_device(device)
    d = c45.on_device(ds, dev)
    nodes = c45._Nodes.new()
    order: deque[int] = deque()        # emission (= BFS) order, apply cursor
    ready: dict[int, c45.SplitDecision] = {}
    depth_of: dict[int, int] = {}
    quarantined: list[TaskFailure] = []

    def make_task(nid: int, idx, w, active) -> NodeTask:
        return NodeTask(node_id=nid, idx=idx, w=w, active=active,
                        depth=depth_of[nid], cls=int(nodes.cls[nid]),
                        freq=nodes.freq[nid])

    def apply_ready(send) -> None:
        """splitPost in emission order: ids match the sequential oracle."""
        while order and order[0] in ready:
            nid = order.popleft()
            dec = ready.pop(nid)
            if dec.is_leaf:
                continue
            nodes.attr[nid] = dec.attr
            nodes.split_bin[nid] = dec.split_bin
            nodes.nchild[nid] = dec.n_children
            first = None
            for j in range(dec.n_children):
                cid = nodes.add(cls=dec.child_cls[j], freq=dec.child_freq[j],
                                depth=depth_of[nid] + 1)
                depth_of[cid] = depth_of[nid] + 1
                if first is None:
                    first = cid
                order.append(cid)
                t = make_task(cid, dec.child_idx[j], dec.child_w[j],
                              dec.child_active)
                send(t, weight=float(max(len(t.idx), 1)))
            nodes.child0[nid] = first

    def emitter(task: Any, send) -> None:
        if task is None:                       # start-up: emit the root
            root_idx, root_w, root_active = c45.root_task(
                ds, dev, attr_mask=attr_mask, case_w=case_w)
            root_freq = c45.class_frequencies(d, root_idx, root_w)
            root = nodes.add(cls=int(np.argmax(root_freq)), freq=root_freq,
                             depth=0)
            depth_of[root] = 0
            order.append(root)
            send(make_task(root, root_idx, root_w, root_active),
                 weight=float(ds.n_cases))
            return
        if isinstance(task, TaskFailure):      # quarantined: degrade to leaf
            quarantined.append(task)
            ready[task.payload.node_id] = c45.SplitDecision()
        else:
            nid, dec = task
            ready[nid] = dec
        apply_ready(send)

    def worker(t: NodeTask):
        return t.node_id, c45.split_node(
            d, cfg, idx=t.idx, w=t.w, active=t.active, depth=t.depth,
            freq=t.freq, cls=t.cls)

    farm = Farm(n_workers, policy=policy, fault=fault, tracer=tracer,
                metrics=metrics)
    svc = injector.wrap_worker(worker) if injector is not None else worker
    stats = farm.run(emitter, svc)
    if stats_out is not None:
        stats_out.update(stats)
    if strict and quarantined:
        raise QuarantinedNodes(quarantined)
    return nodes.finish(ds.n_classes, capacity, dev)
