"""Farm task-scheduling policies (paper Sect. 5, Fig. 13).

The emitter assigns each outgoing task to a worker queue according to one of:

  DRR — Dynamic Round-Robin: cycle through workers, skipping full queues
        (paper uses queue size 4096).
  OD  — On-Demand: DRR with queue size 1 (fully online).
  WS  — Weighted Scheduling: the paper's contribution — each task carries a
        weight (= r, the number of cases at the node) and goes to the worker
        with the lowest total queued+running weight.

Policies are pure-Python and deliberately tiny: they are shared by the real
threaded farm (:mod:`repro_torch.core.farm`), the discrete-event simulator
(:mod:`repro_torch.core.simulate`) and the serving engine's request
dispatcher.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence


class WorkerView(Protocol):
    """What a policy may observe about a worker (FastFlow lock-free queues
    expose exactly queue occupancy; WS additionally tracks weights)."""

    def queue_len(self) -> int: ...
    def queued_weight(self) -> float: ...
    def capacity(self) -> int: ...


@dataclasses.dataclass
class QueueState:
    """Plain-data WorkerView used by the simulator and tests."""
    tasks: int = 0
    weight: float = 0.0
    cap: int = 4096

    def queue_len(self) -> int:
        return self.tasks

    def queued_weight(self) -> float:
        return self.weight

    def capacity(self) -> int:
        return self.cap


class Policy:
    name = "base"

    def pick(self, weight: float, workers: Sequence[WorkerView]) -> int | None:
        """Return the worker index, or None when every queue is full."""
        raise NotImplementedError


class DRR(Policy):
    """Dynamic Round-Robin, skipping workers with a full input queue."""

    name = "drr"

    def __init__(self) -> None:
        self._next = 0

    def pick(self, weight: float, workers: Sequence[WorkerView]) -> int | None:
        n = len(workers)
        for off in range(n):
            i = (self._next + off) % n
            if workers[i].queue_len() < workers[i].capacity():
                self._next = (i + 1) % n
                return i
        return None


class OD(DRR):
    """On-Demand: DRR over queues of capacity 1 (the farm enforces cap=1)."""

    name = "od"
    forced_capacity = 1


class WS(Policy):
    """Weighted Scheduling: least total queued weight wins (ties: lowest id).

    This is the policy the paper adds to FastFlow for YaDT-FF; with task
    weight = r it behaves like an efficient online scheduler (Fig. 13).
    """

    name = "ws"

    def pick(self, weight: float, workers: Sequence[WorkerView]) -> int | None:
        best, best_w = None, float("inf")
        for i, wk in enumerate(workers):
            if wk.queue_len() >= wk.capacity():
                continue
            qw = wk.queued_weight()
            if qw < best_w:
                best, best_w = i, qw
        return best


class HealthWS(WS):
    """WS scaled by per-worker health: projected-finish-time scheduling.

    ``speed_fn`` returns ``{worker_index: speed}`` — the relative throughput
    factors from :meth:`repro.train.elastic.StragglerMonitor.ws_weights`
    (fleet_median / worker_median; a straggler scores < 1).  A worker's
    effective load is ``(queued_weight + task_weight) / speed``, so slow
    hosts receive proportionally less work.  Speed 0 marks a worker
    unhealthy (heartbeat-failed): it is skipped entirely unless every
    healthy queue is full, in which case plain WS over whatever has
    capacity is the fallback (progress beats placement).
    """

    name = "health_ws"

    def __init__(self, speed_fn) -> None:
        self.speed_fn = speed_fn

    def pick(self, weight: float, workers: Sequence[WorkerView]) -> int | None:
        speeds = self.speed_fn() or {}
        best, best_w = None, float("inf")
        fallback, fallback_w = None, float("inf")
        for i, wk in enumerate(workers):
            if wk.queue_len() >= wk.capacity():
                continue
            qw = wk.queued_weight()
            if qw < fallback_w:
                fallback, fallback_w = i, qw
            speed = speeds.get(i, 1.0)
            if speed <= 0.0:
                continue
            eff = (qw + weight) / speed
            if eff < best_w:
                best, best_w = i, eff
        return best if best is not None else fallback


def make_policy(name: str, *, speed_fn=None) -> Policy:
    """Policy factory by name: ``drr | od | ws | health_ws``.

    ``speed_fn`` is the :class:`HealthWS` hook (``{worker_index: speed}``,
    e.g. :meth:`repro.train.elastic.FarmHealth.speeds`); with no hook every
    worker scores speed 1.0 and ``health_ws`` degenerates to plain WS.
    """
    name = name.lower()
    if name == "drr":
        return DRR()
    if name == "od":
        return OD()
    if name == "ws":
        return WS()
    if name == "health_ws":
        return HealthWS(speed_fn if speed_fn is not None else dict)
    raise ValueError(
        f"unknown scheduling policy {name!r} (drr|od|ws|health_ws)")
