"""Deterministic fault injection for the farm and the serving stack.

Every failure mode the supervised farm (:mod:`repro_torch.core.farm`) and
the serving engine must tolerate can be injected here, *deterministically*:
decisions are a pure hash of ``(seed, task key, call number)``, so the same
seed produces the same fault schedule regardless of thread interleaving —
chaos tests are replayable, and the schedule is the JAX package's for the
same seed and key (``_draw`` is its hash, copied verbatim).

Farm side — :class:`FaultInjector` wraps a ``worker_svc``:

  * ``crash_p``  — the task attempt raises :class:`InjectedCrash`
                   (worker survives; supervisor retries the task);
  * ``die_p``    — the *worker* raises
                   :class:`~repro_torch.core.farm.WorkerCrashed` (thread
                   death; farm degrades to fewer workers);
  * ``hang_p``   — the attempt sleeps ``hang_s`` seconds (a task deadline
                   should declare the worker hung-dead first);
  * ``slow_p``   — the attempt sleeps ``slow_s`` then completes normally
                   (straggler; exercises WS/health rebalancing);
  * ``dead_workers`` — these worker indices die on their first task
                   (a permanently lost core).

Serving side — :class:`ChaosReplica` proxies a ``serve.engine.Replica`` and
kills it (raises from ``tick``/``admit``) at a chosen tick, so replica
failover is unit-testable without real hardware faults.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable

from repro_torch.core.farm import WORKER_CTX, WorkerCrashed


class InjectedCrash(RuntimeError):
    """A fault-injected task failure (the worker itself survives)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Probabilities (per task attempt) and magnitudes of injected faults.

    Probabilities are evaluated in order crash -> die -> hang -> slow on one
    uniform draw, so they must sum to <= 1.
    """

    crash_p: float = 0.0
    die_p: float = 0.0
    hang_p: float = 0.0
    slow_p: float = 0.0
    hang_s: float = 2.0
    slow_s: float = 0.02
    dead_workers: frozenset = frozenset()

    def __post_init__(self):
        if self.crash_p + self.die_p + self.hang_p + self.slow_p > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")


class FaultInjector:
    """Seeded, schedule-deterministic fault wrapper for a ``worker_svc``.

    ``key_fn`` maps a task payload to a stable key (default ``repr``); the
    n-th call for a given key always draws the same fault decision for a
    given seed, independent of which worker runs it or when.
    """

    def __init__(self, seed: int = 0, spec: FaultSpec | None = None, *,
                 key_fn: Callable[[Any], Any] = repr):
        self.seed = seed
        self.spec = spec or FaultSpec()
        self.key_fn = key_fn
        self._calls: dict[Any, int] = {}
        self._lock = threading.Lock()
        self.log: list[tuple[Any, int, str]] = []   # (key, call#, action)

    def _draw(self, key: Any, call: int) -> float:
        digest = hashlib.sha256(
            f"{self.seed}|{key}|{call}".encode()).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64)

    def decide(self, key: Any, call: int) -> str:
        u = self._draw(key, call)
        s = self.spec
        for p, action in ((s.crash_p, "crash"), (s.die_p, "die"),
                          (s.hang_p, "hang"), (s.slow_p, "slow")):
            if u < p:
                return action
            u -= p
        return "ok"

    def wrap_worker(self, svc: Callable[[Any], Any]) -> Callable[[Any], Any]:
        def wrapped(payload: Any) -> Any:
            widx = getattr(WORKER_CTX, "idx", None)
            if widx is not None and widx in self.spec.dead_workers:
                raise WorkerCrashed(f"injected: worker {widx} is dead")
            key = self.key_fn(payload)
            with self._lock:
                call = self._calls.get(key, 0)
                self._calls[key] = call + 1
            action = self.decide(key, call)
            with self._lock:
                self.log.append((key, call, action))
            if action == "crash":
                raise InjectedCrash(f"injected crash: task {key} try {call}")
            if action == "die":
                raise WorkerCrashed(f"injected death: worker {widx}")
            if action == "hang":
                time.sleep(self.spec.hang_s)
            elif action == "slow":
                time.sleep(self.spec.slow_s)
            return svc(payload)
        return wrapped


class ChaosReplica:
    """Proxy a serving ``Replica``; kill it at a chosen engine tick.

    ``fail_at_tick``  — ``tick()`` raises :class:`InjectedCrash` on the n-th
                        call (1-based) and every call after it.
    ``admit_failures``— the first n ``admit()`` calls raise the scheduler-race
                        ``RuntimeError`` the engine must absorb by requeueing.
    """

    def __init__(self, replica: Any, *, fail_at_tick: int | None = None,
                 admit_failures: int = 0):
        self._inner = replica
        self.fail_at_tick = fail_at_tick
        self.admit_failures = admit_failures
        self.ticks = 0

    def tick(self):
        self.ticks += 1
        if self.fail_at_tick is not None and self.ticks >= self.fail_at_tick:
            raise InjectedCrash(f"injected replica death at tick {self.ticks}")
        return self._inner.tick()

    def admit(self, req):
        if self.admit_failures > 0:
            self.admit_failures -= 1
            raise RuntimeError("no free slot (injected scheduler race)")
        return self._inner.admit(req)

    def __getattr__(self, name):
        return getattr(self._inner, name)
