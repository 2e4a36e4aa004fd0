"""Slot-batched serving engine with WS request scheduling and failover.

The port of ``repro.serve.engine``: the same scheduling, failover,
requeue, deadline, metrics and trace semantics, on the port's
``core.scheduler`` and ``obs``.  A :class:`Replica` holds its cache on a
device (None: the card), prefills each admitted prompt through the flash
kernel there, splices the batch-1 cache into its slot in place and
decodes every slot with one ``decode_step`` a tick (in place too).

The paper's farm is applied here as a *runtime feature* (DESIGN.md §5): a
fleet of model replicas is a farm; requests are tasks whose weight is
``len(prompt) + max_new_tokens`` — the total token work the request will
occupy a slot for, prefill plus decode (the serving analogue of weight = r
cases at a node); the emitter assigns each request to the replica with the
least outstanding weighted work — FastFlow's ``ws_scheduler`` verbatim,
from :mod:`repro_torch.core.scheduler`.  Any of the paper's policies can be
selected by name (``drr | od | ws | health_ws``); ``od`` admits at most
``Policy.forced_capacity`` (= 1) newly-queued requests per replica per
tick, and admission always considers the *full* replica list with evicted
replicas masked as zero-capacity, so round-robin state never drifts across
a failover.

Each replica runs **continuous batching** over a fixed number of cache
slots: one ``decode_step`` advances every active slot per tick;
prompts are prefilled into free slots (batch-1 prefill merged into the slot
axis); finished sequences free their slot immediately.

The engine is additionally **fault-tolerant** (see README "Fault model"):

  * a replica whose ``tick``/``admit`` raises is *evicted* — marked
    unhealthy, never scheduled again — and its in-flight requests are
    re-admitted to the backlog (bounded by ``max_requeues``; a request over
    budget becomes an explicit :class:`RequestFailure`);
  * replica liveness can also be driven by a
    :class:`~repro_torch.train.elastic.HeartbeatMonitor` measured in engine
    ticks (``heartbeat_ticks``): the engine beats host ``"replica{i}"`` on every
    successful tick and evicts replicas the monitor declares failed;
  * per-request deadlines (``Request.deadline_ticks``, measured from
    submission) cancel the slot and surface a ``"timeout"`` failure with
    the partial decode;
  * ``run_until_drained`` accounts for **every** submitted request: each
    ends as exactly one :class:`Completion` or one :class:`RequestFailure`
    (``engine.failed``) — hitting ``max_ticks`` or losing the last replica
    produces explicit failure records, never a silently dropped request.

Scheduler races on admission (``Replica.admit`` finding no free slot) are
absorbed by requeueing the request rather than crashing the engine loop.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.scheduler import Policy, QueueState, make_policy
from repro_torch.models.model import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.sampling import sample
from repro_torch.train.elastic import HeartbeatMonitor


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    deadline_ticks: int | None = None   # budget in engine ticks, from submit

    @property
    def weight(self) -> float:
        return float(len(self.prompt) + self.max_new_tokens)


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]


@dataclasses.dataclass
class RequestFailure:
    """Explicit terminal record for a request that did not complete."""

    uid: int
    reason: str                 # timeout | replica_dead | requeue_exhausted |
                                # no_replicas | max_ticks
    detail: str = ""
    tokens: list = dataclasses.field(default_factory=list)   # partial decode


class Replica:
    """One model replica: fixed slot batch + shared cache on ``device``
    (None: the card; raises without one)."""

    def __init__(self, model: Model, params: Any, *, n_slots: int,
                 max_seq: int, seed: int = 0, device=None):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = model.init_cache(n_slots, max_seq, self.device)
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.pos = np.zeros(n_slots, np.int64)            # next write index
        self.remaining = np.zeros(n_slots, np.int64)
        self.active = np.zeros(n_slots, bool)
        self.uid = np.full(n_slots, -1, np.int64)
        self.out: dict[int, list[int]] = {}
        self.generator = torch.Generator(self.device)
        self.generator.manual_seed(seed)

    # -- WorkerView for the WS policy ---------------------------------------
    def queue_len(self) -> int:
        return int(self.active.sum())

    def queued_weight(self) -> float:
        return float(self.remaining[self.active].sum())

    def capacity(self) -> int:
        return self.n_slots

    # -- failover introspection ----------------------------------------------
    def active_uids(self) -> list[int]:
        return [int(u) for u in self.uid[self.active]]

    def release(self, uid: int) -> list[int]:
        """Cancel a request's slot; returns its partial decode."""
        for s in range(self.n_slots):
            if self.active[s] and int(self.uid[s]) == uid:
                self.active[s] = False
                self.uid[s] = -1
                return self.out.pop(uid, [])
        return self.out.pop(uid, [])

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request) -> None:
        free = np.flatnonzero(~self.active)
        if not free.size:
            raise RuntimeError("no free slot (scheduler race)")
        s = int(free[0])
        prompt = torch.as_tensor(np.asarray(req.prompt), device=self.device)
        logits, cache1 = self.model.prefill(self.params, prompt[None],
                                            max_seq=self.max_seq)
        # splice the batch-1 prefill cache into slot s of the shared cache
        for big, one in zip(self.cache, _pad_cache_seq(cache1, self.cache)):
            for name, t in one.items():
                big[name][s:s + 1].copy_(t)
        tok = int(torch.argmax(logits, -1)[0])
        self.tokens[s, 0] = tok
        self.pos[s] = len(req.prompt)
        self.remaining[s] = req.max_new_tokens - 1
        self.active[s] = True
        self.uid[s] = req.uid
        self.out[req.uid] = [tok]

    # -- one decode tick over all active slots -------------------------------
    def tick(self) -> list[Completion]:
        if not self.active.any():
            return []
        # Per-slot positions: every active slot advances at its own index
        # (continuous batching); the decode step masks per row.  As in the
        # JAX engine, the step samples with the default temperature (greedy)
        # whatever a request's ``temperature`` says.
        pos_vec = torch.as_tensor(self.pos, dtype=torch.int32,
                                  device=self.device)
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    self.tokens, pos_vec)
        nxt = sample(logits, self.generator).cpu().numpy()
        done: list[Completion] = []
        for s in range(self.n_slots):
            if not self.active[s]:
                continue
            tok = int(nxt[s])
            self.out[int(self.uid[s])].append(tok)
            self.pos[s] += 1
            self.remaining[s] -= 1
            if self.remaining[s] <= 0 or self.pos[s] >= self.max_seq - 1:
                done.append(Completion(int(self.uid[s]),
                                       self.out.pop(int(self.uid[s]))))
                self.active[s] = False
                self.uid[s] = -1
        self.tokens = torch.as_tensor(nxt[:, None], dtype=torch.int32,
                                      device=self.device)
        return done


def _pad_cache_seq(cache_small: list, cache_big: list) -> list:
    """Zero-pad a prefill cache (seq = prompt len) to the slot cache shape."""
    out = []
    for small, big in zip(cache_small, cache_big):
        slot = {}
        for k, v in small.items():
            tgt = big[k].shape[1:]
            pads = []
            for s, t in zip(reversed(v.shape[1:]), reversed(tgt)):
                pads += [0, t - s]
            slot[k] = torch.nn.functional.pad(v, pads)
        out.append(slot)
    return out


class ServingEngine:
    """Front door: WS-scheduled admission over a fleet of replicas, with
    replica failover, bounded requeues and explicit drain accounting."""

    def __init__(self, replicas: list, *, policy: str | Policy = "ws",
                 speed_fn=None,
                 heartbeat: HeartbeatMonitor | None = None,
                 heartbeat_ticks: int | None = None,
                 max_requeues: int = 2,
                 default_deadline_ticks: int | None = None,
                 tracer: obs_trace.Tracer | None = None,
                 metrics: obs_metrics.Registry | None = None):
        self.replicas = replicas
        self.policy = policy if isinstance(policy, Policy) \
            else make_policy(policy, speed_fn=speed_fn)
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        reg = metrics if metrics is not None else obs_metrics.REGISTRY
        self._m_submitted = reg.counter(
            "engine_requests_total", "requests submitted")
        self._m_completed = reg.counter(
            "engine_completions_total", "requests completed")
        self._m_failed = reg.counter(
            "engine_failures_total", "terminal failures, by reason")
        self._m_evictions = reg.counter(
            "engine_evictions_total", "replicas evicted")
        self._m_requeues = reg.counter(
            "engine_requeues_total", "requests re-admitted after a fault")
        self._m_queue_wait = reg.histogram(
            "engine_queue_wait_ticks", "ticks from submit to first admit")
        self._m_latency = reg.histogram(
            "engine_request_ticks", "ticks from submit to terminal record")
        self.heartbeat = heartbeat
        if self.heartbeat is None and heartbeat_ticks is not None:
            self.heartbeat = HeartbeatMonitor(timeout=heartbeat_ticks)
        self.max_requeues = max_requeues
        self.default_deadline_ticks = default_deadline_ticks
        self.healthy = [True] * len(replicas)
        self.backlog: deque[Request] = deque()
        self.completed: list[Completion] = []
        self.failed: list[RequestFailure] = []
        self._inflight: dict[int, tuple[Request, int]] = {}   # uid -> (req, i)
        self._requeues: dict[int, int] = {}
        self._submit_tick: dict[int, int] = {}
        self._admit_tick: dict[int, int] = {}
        self._tick = 0

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> None:
        self._submit_tick.setdefault(req.uid, self._tick)
        self._m_submitted.inc()
        self.tracer.begin("request", id=req.uid, weight=req.weight)
        self.backlog.append(req)

    def _admit_backlog(self) -> None:
        # The policy always sees the *full* replica list: evicted replicas
        # are masked as zero-capacity views, so a stateful policy's pointer
        # (DRR._next) keeps addressing physical replicas across failover.
        # With a forced-capacity policy (OD), "queued" means newly admitted
        # this call — at most forced_capacity fresh requests per replica per
        # tick, and never more than the replica's free slots.
        forced = getattr(self.policy, "forced_capacity", None)
        newly = [0] * len(self.replicas)
        while self.backlog:
            if not any(self.healthy):
                return
            views = []
            for i, rep in enumerate(self.replicas):
                if not self.healthy[i]:
                    views.append(QueueState(tasks=0, weight=0.0, cap=0))
                    continue
                used, qw = rep.queue_len(), rep.queued_weight()
                if forced is not None:
                    views.append(QueueState(
                        tasks=newly[i], weight=qw,
                        cap=min(forced, rep.capacity() - used)))
                else:
                    views.append(QueueState(tasks=used, weight=qw,
                                            cap=rep.capacity()))
            i = self.policy.pick(self.backlog[0].weight, views)
            if i is None:
                return                       # every healthy replica full
            req = self.backlog.popleft()
            try:
                self.replicas[i].admit(req)
            except RuntimeError as e:
                # Scheduler race: the policy saw a free slot that is gone.
                # Requeue instead of crashing the engine loop.
                if not self._requeue(req, f"admit: {e!r}"):
                    continue
                self.backlog.appendleft(req)
                return
            except Exception as e:
                self._evict(i, f"admit raised: {e!r}")
                self.backlog.appendleft(req)
                continue
            newly[i] += 1
            self._inflight[req.uid] = (req, i)
            if req.uid not in self._admit_tick:
                self._admit_tick[req.uid] = self._tick
                self._m_queue_wait.observe(
                    self._tick - self._submit_tick[req.uid])
            self.tracer.instant("request.admit", uid=req.uid, replica=i)

    def _fail(self, failure: RequestFailure) -> None:
        """Record one terminal failure (the only way ``failed`` grows)."""
        self.failed.append(failure)
        self._m_failed.inc(reason=failure.reason)
        self._m_latency.observe(
            self._tick - self._submit_tick.get(failure.uid, self._tick))
        self.tracer.end("request", id=failure.uid, outcome=failure.reason)

    def _requeue(self, req: Request, detail: str) -> bool:
        """Charge one requeue; False = budget exhausted (request failed)."""
        n = self._requeues.get(req.uid, 0)
        if n >= self.max_requeues:
            self._fail(RequestFailure(req.uid, "requeue_exhausted", detail))
            return False
        self._requeues[req.uid] = n + 1
        self._m_requeues.inc()
        self.tracer.instant("request.requeue", uid=req.uid, detail=detail)
        return True

    # ------------------------------------------------------------- failover
    def _evict(self, i: int, detail: str) -> None:
        """Remove replica i from service; re-admit its in-flight requests."""
        if not self.healthy[i]:
            return
        self.healthy[i] = False
        self._m_evictions.inc()
        self.tracer.instant("replica.evict", replica=i, detail=detail)
        rep = self.replicas[i]
        try:
            uids = rep.active_uids()
        except Exception:
            uids = [u for u, (_, j) in self._inflight.items() if j == i]
        for uid in uids:
            ent = self._inflight.pop(uid, None)
            if ent is None:
                continue
            req, _ = ent
            if self._requeue(req, f"replica {i} evicted: {detail}"):
                self.backlog.appendleft(req)

    def _expire_deadlines(self) -> None:
        for uid, (req, i) in list(self._inflight.items()):
            ddl = req.deadline_ticks or self.default_deadline_ticks
            if ddl is None or self._tick - self._submit_tick[uid] < ddl:
                continue
            del self._inflight[uid]
            partial: list[int] = []
            if self.healthy[i]:
                try:
                    partial = self.replicas[i].release(uid)
                except Exception:
                    pass
            self._fail(RequestFailure(
                uid, "timeout", f"deadline {ddl} ticks exceeded", partial))
        for req in [r for r in self.backlog]:
            ddl = req.deadline_ticks or self.default_deadline_ticks
            if ddl is not None and self._tick - self._submit_tick[req.uid] >= ddl:
                self.backlog.remove(req)
                self._fail(RequestFailure(
                    req.uid, "timeout", f"deadline {ddl} ticks exceeded "
                    "while queued"))

    def _fail_remaining(self, reason: str, detail: str) -> None:
        for uid, (req, i) in list(self._inflight.items()):
            partial = []
            if self.healthy[i]:
                try:
                    partial = self.replicas[i].release(uid)
                except Exception:
                    pass
            self._fail(RequestFailure(uid, reason, detail, partial))
        self._inflight.clear()
        while self.backlog:
            req = self.backlog.popleft()
            self._fail(RequestFailure(req.uid, reason, detail))

    # ------------------------------------------------------------- main loop
    def run_until_drained(self, *, max_ticks: int = 10_000
                          ) -> list[Completion]:
        """Tick until every submitted request has a terminal record.

        Returns the completions (as before); explicit failure/timeout
        records accumulate in ``self.failed`` — nothing is dropped silently,
        including at ``max_ticks``.
        """
        for _ in range(max_ticks):
            self._tick += 1
            with self.tracer.span("engine.tick", tick=self._tick):
                if self.heartbeat is not None:
                    for h in self.heartbeat.failed(now=self._tick):
                        if h.startswith("replica"):
                            i = int(h[len("replica"):])
                            if 0 <= i < len(self.replicas) \
                                    and self.healthy[i]:
                                self._evict(i, "heartbeat timeout")
                with self.tracer.span("engine.admit"):
                    self._admit_backlog()
                busy = False
                for i, rep in enumerate(self.replicas):
                    if not self.healthy[i]:
                        continue
                    try:
                        with self.tracer.span(f"replica{i}.tick"):
                            done = rep.tick()
                    except Exception as e:
                        self._evict(i, f"tick raised: {e!r}")
                        continue
                    if self.heartbeat is not None:
                        self.heartbeat.beat(f"replica{i}", now=self._tick)
                    for c in done:
                        self._inflight.pop(c.uid, None)
                        self.completed.append(c)
                        self._m_completed.inc()
                        self._m_latency.observe(
                            self._tick - self._submit_tick[c.uid])
                        self.tracer.end("request", id=c.uid, outcome="ok")
                    busy |= rep.queue_len() > 0
                    self.tracer.counter(f"replica{i}.queued_weight",
                                        weight=rep.queued_weight())
                self._expire_deadlines()
            if not any(self.healthy) and (self.backlog or self._inflight):
                self._fail_remaining("no_replicas",
                                     "all replicas evicted")
                break
            if not busy and not self.backlog and not self._inflight:
                break
        else:
            self._fail_remaining(
                "max_ticks", f"undrained after {max_ticks} ticks")
        return self.completed

    def stats(self) -> dict[str, Any]:
        """Serving-side failure breakdown (mirrors ``Farm.stats()``)."""
        reasons: dict[str, int] = {}
        for f in self.failed:
            reasons[f.reason] = reasons.get(f.reason, 0) + 1
        return dict(
            ticks=self._tick,
            completed=len(self.completed),
            failed=len(self.failed),
            failed_by_reason=reasons,
            requeues=sum(self._requeues.values()),
            evicted_replicas=[i for i, h in enumerate(self.healthy) if not h],
            healthy_replicas=sum(self.healthy),
        )
