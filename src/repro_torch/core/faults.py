"""Deterministic fault injection for the serving stack.

:class:`ChaosReplica` proxies a ``serve.engine.Replica`` and kills it
(raises from ``tick``/``admit``) at a chosen tick, so replica failover is
unit-testable without real hardware faults.  A copy of that part of the
JAX package's ``core.faults``; the farm-side ``FaultInjector`` comes with
the farm build.
"""

from __future__ import annotations

from typing import Any


class InjectedCrash(RuntimeError):
    """A fault-injected task failure (the worker itself survives)."""


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
