"""Host liveness for the serving engine (control plane).

:class:`HeartbeatMonitor` — hosts report liveness; a host silent for
``timeout`` (seconds, or engine ticks when the caller passes ``now``) is
declared failed.  A copy of that part of the JAX package's
``train.elastic``; the mesh planning and straggler monitor come with the
training slice.
"""

from __future__ import annotations

import dataclasses
import time

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
