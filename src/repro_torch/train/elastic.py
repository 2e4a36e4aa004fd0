"""Failure detection and straggler mitigation (host control plane).

  * :class:`HeartbeatMonitor` — hosts report liveness; a host silent for
    ``timeout`` (seconds, or engine ticks when the caller passes ``now``)
    is declared failed.
  * :class:`StragglerMonitor` — per-step durations; hosts slower than
    ``factor`` x the running median get flagged, and their WS weights
    shrink.
  * :class:`FarmHealth` — feeds the supervised farm's task and death events
    into both and returns the :class:`~repro_torch.core.scheduler.HealthWS`
    policy that schedules by them.

A copy of those parts of the JAX package's ``train.elastic``; its mesh
planning (``plan_mesh``, ``rebatch_for_mesh``) comes with the LM training
path.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque

from repro_torch.core.scheduler import HealthWS
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class HostState:
    last_seen: float
    step: int = -1


class HeartbeatMonitor:
    def __init__(self, timeout: float = 60.0,
                 metrics: obs_metrics.Registry | None = None):
        self.timeout = timeout
        self.hosts: dict[str, HostState] = {}
        reg = metrics if metrics is not None else obs_metrics.REGISTRY
        self._m_beats = reg.counter(
            "heartbeat_beats_total", "liveness reports, by host= label")
        self._m_alive = reg.gauge(
            "heartbeat_hosts_alive", "hosts within the liveness timeout")
        self._m_failed = reg.gauge(
            "heartbeat_hosts_failed", "hosts past the liveness timeout")

    def beat(self, host: str, step: int = -1,
             now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.hosts[host] = HostState(last_seen=now, step=step)
        self._m_beats.inc(host=host)

    def failed(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        bad = [h for h, s in self.hosts.items()
               if now - s.last_seen > self.timeout]
        self._m_failed.set(len(bad))
        self._m_alive.set(len(self.hosts) - len(bad))
        return bad

    def alive(self, now: float | None = None) -> list[str]:
        bad = set(self.failed(now))
        return [h for h in self.hosts if h not in bad]


class StragglerMonitor:
    """Flags hosts whose recent step times exceed factor x fleet median."""

    def __init__(self, factor: float = 1.5, window: int = 16):
        self.factor = factor
        self.times: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host: str, seconds: float) -> None:
        self.times[host].append(seconds)

    def _median(self, xs: list[float]) -> float:
        xs = sorted(xs)
        return xs[len(xs) // 2]

    def stragglers(self) -> list[str]:
        if len(self.times) < 2:
            return []
        med = self._median([self._median(list(v)) for v in self.times.values()
                            if v])
        return [h for h, v in self.times.items()
                if v and self._median(list(v)) > self.factor * med]

    def ws_weights(self) -> dict[str, float]:
        """Relative work weights for the WS scheduler: slow host -> less work.

        This plugs the paper's weighted scheduling into straggler mitigation:
        host-side tasks are dispatched with Farm(policy=WS()) where each
        host's queue weight is scaled by its observed slowdown.
        """
        if not self.times:
            return {}
        meds = {h: self._median(list(v)) for h, v in self.times.items() if v}
        fleet = self._median(list(meds.values()))
        return {h: fleet / m for h, m in meds.items()}


class FarmHealth:
    """Bridge the farm's execution events into the control plane.

    The supervised farm (:class:`repro_torch.core.farm.Farm`) calls ``on_task``
    per completed attempt and ``on_worker_dead`` per lost worker; this class
    feeds those events into :class:`HeartbeatMonitor` (liveness) and
    :class:`StragglerMonitor` (per-worker speed), and closes the loop by
    producing the :class:`~repro_torch.core.scheduler.HealthWS` policy that
    scales the paper's WS weights with observed worker health —
    straggler-aware, dead-worker-avoiding task placement.  Worker ``i`` is host ``"w{i}"`` in
    both monitors.
    """

    def __init__(self, n_workers: int, *,
                 heartbeat: HeartbeatMonitor | None = None,
                 straggler: StragglerMonitor | None = None):
        self.n_workers = n_workers
        self.heartbeat = heartbeat or HeartbeatMonitor()
        self.straggler = straggler or StragglerMonitor()
        self.dead: set[int] = set()

    @staticmethod
    def host(idx: int) -> str:
        return f"w{idx}"

    # -- farm-side hooks -----------------------------------------------------
    def on_task(self, idx: int, seconds: float,
                now: float | None = None) -> None:
        self.straggler.record(self.host(idx), seconds)
        self.heartbeat.beat(self.host(idx), now=now)

    def on_worker_dead(self, idx: int) -> None:
        self.dead.add(idx)

    # -- scheduler-side view -------------------------------------------------
    def speeds(self, now: float | None = None) -> dict[int, float]:
        """Per-worker speed factors; 0.0 = do not schedule (dead/silent)."""
        w = self.straggler.ws_weights()
        failed = set(self.heartbeat.failed(now))
        out: dict[int, float] = {}
        for i in range(self.n_workers):
            if i in self.dead or self.host(i) in failed:
                out[i] = 0.0
            else:
                out[i] = w.get(self.host(i), 1.0)
        return out

    def policy(self) -> HealthWS:
        return HealthWS(self.speeds)
