"""Discrete-event simulator of the YaDT-FF farm (paper Figs. 8/9/13, Table 2).

The JAX package's ``core.simulate``, on the host: it replays the real task
DAG recorded from a tree build (``c45.build(task_trace=...)``, on the card
or the CPU) through an event-level model of the FastFlow farm, so the
paper's speedup-against-workers curves come from a trace and a calibrated
grain model, not from wall clocks:

  * one serial emitter (start-up dispatch, per-feedback handling, per-task
    emission overhead — its busy fraction reproduces Fig. 14);
  * ``n_workers`` serial workers with bounded FIFO input queues;
  * the DRR / OD / WS policies of :mod:`repro_torch.core.scheduler`,
    consulting queue occupancy exactly at dispatch time (FastFlow
    semantics: the emitter spins when every queue is full);
  * NP tasks (one ``node::split`` per node) or NAP tasks (``splitPre`` at
    the emitter, one ``splitAtt`` per attribute on workers, ``splitPost``
    barrier at the emitter) chosen per node by the configured
    ``buildAttTest`` cost model — the schedule of paper Fig. 15.

Task service times follow the paper's grain model (quicksort-dominated:
``c·r·log r``) with the constant κ calibrated against a measured sequential
build, so simulated speedups are anchored to real work.  It takes a list
of dicts and returns plain floats; nothing here touches a device.  The one
tensor is the NAP test's (``cost_models.build_att_test`` on the CPU), so a
decision compares in float32 as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Sequence

from repro_torch.core import cost_models
from repro_torch.core.scheduler import Policy, QueueState, make_policy


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Service-time model (seconds) for farm entities."""
    kappa: float = 1e-8        # seconds per grain unit (calibrated)
    task_fixed: float = 2e-6   # per-task fixed worker overhead
    emit_overhead: float = 5e-7  # emitter cost per handled/emitted task
    freq_unit: float = 1.0     # computeFrequencies / partition grain per case

    def node_cost(self, r: float, c: float) -> float:
        g = self.freq_unit * r + c * r * max(math.log2(max(r, 2.0)), 1.0)
        return self.task_fixed + self.kappa * g

    def leaf_cost(self, r: float) -> float:
        return self.task_fixed + self.kappa * self.freq_unit * max(r, 1.0)

    def att_cost(self, r: float) -> float:
        g = r * max(math.log2(max(r, 2.0)), 1.0)
        return self.task_fixed + self.kappa * g

    def pre_cost(self, r: float) -> float:
        return self.task_fixed + self.kappa * self.freq_unit * max(r, 1.0)


def calibrate(trace: Sequence[dict], measured_seq_seconds: float,
              **kw) -> CostModel:
    """Fix κ so the modelled sequential time matches a measured build."""
    base = CostModel(kappa=1.0, task_fixed=0.0, emit_overhead=0.0)
    grain = sum(base.node_cost(t["r"], max(t["c"], 1)) if t["n_children"]
                else base.leaf_cost(t["r"]) for t in trace)
    return CostModel(kappa=measured_seq_seconds / max(grain, 1e-12), **kw)


def sequential_time(trace: Sequence[dict], cm: CostModel) -> float:
    return sum(cm.node_cost(t["r"], max(t["c"], 1)) if t["n_children"]
               else cm.leaf_cost(t["r"]) for t in trace)


@dataclasses.dataclass
class SimResult:
    makespan: float
    seq_time: float
    emitter_busy: float
    worker_busy: list[float]
    n_node_tasks: int
    n_att_tasks: int
    nap_choices: list[tuple[int, bool]]   # (depth, used_attribute_par)

    @property
    def speedup(self) -> float:
        return self.seq_time / self.makespan if self.makespan > 0 else 0.0


class _Workers:
    """Per-worker schedule; exposes queue state *as of* a given time."""

    def __init__(self, n: int, cap: int):
        self.free = [0.0] * n
        self.cap = cap
        self.busy = [0.0] * n
        # Queue *occupancy* lasts until the worker pops the task (capacity
        # checks); queued *weight* lasts until completion — FastFlow's
        # ws_scheduler decrements the load only when the result flows back,
        # i.e. running tasks still count (matches core/farm.py accounting).
        self.pending_occ: list[deque] = [deque() for _ in range(n)]
        self.pending_w: list[deque] = [deque() for _ in range(n)]

    def views(self, t: float) -> list[QueueState]:
        out = []
        for i in range(len(self.free)):
            occ, pw = self.pending_occ[i], self.pending_w[i]
            while occ and occ[0] <= t:
                occ.popleft()
            while pw and pw[0][0] <= t:
                pw.popleft()
            out.append(QueueState(tasks=len(occ),
                                  weight=sum(w for _, w in pw),
                                  cap=self.cap))
        return out

    def dispatch(self, i: int, arrival: float, cost: float, weight: float
                 ) -> float:
        start = max(self.free[i], arrival)
        self.free[i] = start + cost
        self.busy[i] += cost
        self.pending_occ[i].append(start)
        self.pending_w[i].append((self.free[i], weight))
        return self.free[i]

    def earliest_pop(self) -> float:
        times = [p[0] for p in self.pending_occ if p]
        return min(times) if times else math.inf


def simulate(
    trace: Sequence[dict],
    *,
    n_workers: int,
    strategy: str = "nap",                 # "np" | "nap"
    policy: str | Policy = "ws",
    queue_size: int = 4096,
    cost: CostModel | None = None,
    cost_model: str = "nsq",               # buildAttTest variant (NAP only)
    alpha: float = 1000.0,
) -> SimResult:
    """Replay a recorded task DAG through the farm model."""
    cm = cost or CostModel()
    pol = policy if isinstance(policy, Policy) else make_policy(policy)
    cap = getattr(pol, "forced_capacity", queue_size)
    workers = _Workers(n_workers, cap)

    by_id = {t["node_id"]: t for t in trace}
    children: dict[int, list[int]] = {t["node_id"]: [] for t in trace}
    for t in trace:
        if t["parent"] >= 0 and t["parent"] in children:
            children[t["parent"]].append(t["node_id"])
    n_total = max((t["r"] for t in trace if t["parent"] < 0), default=1)

    emitter_clock = 0.0
    emitter_busy = 0.0
    events: list[tuple[float, int, str, int]] = []   # (t, seq, kind, node)
    seq = 0
    att_left: dict[int, int] = {}
    n_node_tasks = n_att_tasks = 0
    nap_choices: list[tuple[int, bool]] = []

    def emit(node_id: int, kind: str, svc_cost: float, weight: float) -> None:
        nonlocal emitter_clock, emitter_busy, seq
        emitter_clock += cm.emit_overhead
        emitter_busy += cm.emit_overhead
        while True:
            i = pol.pick(weight, workers.views(emitter_clock))
            if i is not None:
                break
            nxt = workers.earliest_pop()           # spin until a queue frees
            emitter_clock = max(emitter_clock, nxt if nxt < math.inf
                                else emitter_clock)
            if nxt is math.inf:
                raise RuntimeError("deadlock: all queues full, none draining")
        done = workers.dispatch(i, emitter_clock, svc_cost, weight)
        seq += 1
        heapq.heappush(events, (done, seq, kind, node_id))

    def process_node(node_id: int) -> None:
        """Emitter handles a ready node: NP task or NAP decomposition."""
        nonlocal emitter_clock, emitter_busy, n_node_tasks, n_att_tasks
        t = by_id[node_id]
        r, c = t["r"], max(t["c"], 1)
        if t["n_children"] == 0:
            emit(node_id, "NODE", cm.leaf_cost(r), weight=max(r, 1))
            n_node_tasks += 1
            return
        use_att = strategy == "nap" and bool(cost_models.build_att_test(
            cost_model, n_total_cases=float(n_total), r=float(r), c=float(c),
            alpha=alpha))
        nap_choices.append((t["depth"], use_att))
        if use_att:
            # splitPre runs at the emitter before attribute tasks (§7.28-38)
            pre = cm.pre_cost(r)
            emitter_clock += pre
            emitter_busy += pre
            att_left[node_id] = c
            for _ in range(c):
                emit(node_id, "ATT", cm.att_cost(r), weight=max(r, 1))
            n_att_tasks += c
        else:
            emit(node_id, "NODE", cm.node_cost(r, c), weight=max(r, 1))
            n_node_tasks += 1

    process_node(0)                                   # root (§7.3-10)
    while events:
        done_t, _, kind, node_id = heapq.heappop(events)
        emitter_clock = max(emitter_clock, done_t)
        emitter_clock += cm.emit_overhead             # feedback handling
        emitter_busy += cm.emit_overhead
        if kind == "ATT":
            att_left[node_id] -= 1
            if att_left[node_id] > 0:
                continue
            post = cm.pre_cost(1)                     # splitPost at emitter
            emitter_clock += post
            emitter_busy += post
        for ch in children[node_id]:
            process_node(ch)

    makespan = max([emitter_clock] + workers.free)
    return SimResult(
        makespan=makespan,
        seq_time=sequential_time(trace, cm),
        emitter_busy=emitter_busy,
        worker_busy=workers.busy,
        n_node_tasks=n_node_tasks,
        n_att_tasks=n_att_tasks,
        nap_choices=nap_choices,
    )
