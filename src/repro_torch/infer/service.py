"""Microbatching predict service: coalesce, schedule, survive replicas.

Single-row predict requests are individually tiny — the batched kernels
(:mod:`repro_torch.infer.forest`) only pay off when N is large.  This
front-end closes the gap with **microbatching**: requests queue per routing arm
(stable / canary) and a batch closes when it reaches ``max_batch`` rows or
its oldest request has waited ``max_wait_ticks`` engine ticks, trading a
bounded latency floor for kernel-efficient batch shapes.

Closed batches are *tasks on a farm of replicas*, exactly the paper's
emitter/worker shape reused a third time (tree build, LM serving, now
inference): the dispatcher picks a replica per batch with
:func:`repro_torch.core.scheduler.make_policy` (``drr | od | ws |
health_ws``, task weight = batch rows), and replica faults follow the LM
serving engine's failover contract — a replica whose ``admit`` or
``tick`` raises is evicted (masked as a zero-capacity view so stateful
policies keep addressing physical indices), its queued requests are
re-admitted under a bounded per-request requeue budget, and
``run_until_drained`` ends every submitted request as exactly one
:class:`PredictResult` or one :class:`PredictFailure`.

Canary / shadow: a :class:`~repro_torch.infer.registry.ModelHandle` routes
each uid deterministically to an arm; shadow mode mirrors every dispatched batch
to the candidate model and only records agreement metrics.

Everything is instrumented through :mod:`repro_torch.obs`: queue-wait and
batch-size histograms, per-replica busy counters, per-request async spans.

The records, metrics and spans are the JAX package's service's, request for
request.  Each batch's rows go to the forest's device (the card, where the
traversal kernel runs) and its labels come back as numpy.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.scheduler import Policy, QueueState, make_policy
from repro_torch.infer.forest import Forest
from repro_torch.infer.forest import predict as forest_predict
from repro_torch.infer.registry import ModelHandle
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class PredictRequest:
    uid: int
    x_row: np.ndarray            # (A,) binned case; -1 = unknown

    @property
    def weight(self) -> float:
        return 1.0


@dataclasses.dataclass
class PredictResult:
    uid: int
    label: int
    replica: int
    batch_size: int              # rows in the batch that served this uid
    arm: str = "stable"


@dataclasses.dataclass
class PredictFailure:
    """Explicit terminal record for a request that was never served."""

    uid: int
    reason: str                  # replica_dead | requeue_exhausted |
                                 # no_replicas | max_ticks
    detail: str = ""


@dataclasses.dataclass
class _Batch:
    arm: str
    requests: list

    @property
    def weight(self) -> float:
        return float(len(self.requests))


def _predict(forest: Forest, x_rows: np.ndarray, cont: np.ndarray, *,
             impl: str | None, weighted: bool = True) -> np.ndarray:
    """Labels of one batch: rows to the forest's device, labels back."""
    x = torch.as_tensor(x_rows, dtype=torch.int32).to(forest.device)
    return forest_predict(forest, x, cont, impl=impl,
                          weighted=weighted).cpu().numpy()


def _predict_fn(forest: Forest, attr_is_cont, *, impl: str | None,
                weighted: bool = True) -> Callable[[np.ndarray], np.ndarray]:
    cont = np.asarray(attr_is_cont, bool)

    def fn(x_rows: np.ndarray) -> np.ndarray:
        return _predict(forest, x_rows, cont, impl=impl, weighted=weighted)
    return fn


class InferReplica:
    """One inference worker: a bounded queue of batches + per-arm models.

    ``models`` maps routing arm -> batch predict fn ``(n, A) -> (n,)``;
    ``shadow_fn`` (optional) mirrors each batch for comparison only and may
    return ``None`` when no shadow target is armed.  Exposes the
    ``WorkerView`` protocol for the scheduling policies.
    """

    def __init__(self, models: dict[str, Callable], *, max_batches: int = 4,
                 shadow_fn: Callable | None = None):
        if not models:
            raise ValueError("InferReplica: need at least one arm model")
        self.models = models
        self.shadow_fn = shadow_fn
        self.max_batches = max_batches
        self.queue: deque[_Batch] = deque()

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_forest(forest: Forest, attr_is_cont, *, impl: str | None = None,
                    max_batches: int = 4) -> "InferReplica":
        return InferReplica(
            {"stable": _predict_fn(forest, attr_is_cont, impl=impl)},
            max_batches=max_batches)

    @staticmethod
    def from_handle(handle: ModelHandle, attr_is_cont, *,
                    impl: str | None = None, max_batches: int = 4
                    ) -> "InferReplica":
        """Arm fns resolve through the handle at call time, so a
        ``refresh()`` / ``promote_canary()`` hot-swap reaches every replica
        without rebuilding the fleet."""
        cont = np.asarray(attr_is_cont, bool)

        def arm_fn(arm: str):
            def fn(x_rows: np.ndarray) -> np.ndarray:
                model = handle.stable if arm == "stable" else handle.canary
                if model is None:
                    raise RuntimeError(f"no {arm} model armed")
                return _predict(model, x_rows, cont, impl=impl)
            return fn

        def shadow(x_rows: np.ndarray):
            model = handle.shadow_model()
            if model is None:
                return None
            return _predict(model, x_rows, cont, impl=impl)

        return InferReplica({"stable": arm_fn("stable"),
                             "canary": arm_fn("canary")},
                            max_batches=max_batches, shadow_fn=shadow)

    # -- WorkerView for the scheduling policies ------------------------------
    def queue_len(self) -> int:
        return len(self.queue)

    def queued_weight(self) -> float:
        return float(sum(len(b.requests) for b in self.queue))

    def capacity(self) -> int:
        return self.max_batches

    # -- admission / work ----------------------------------------------------
    def admit(self, batch: _Batch) -> None:
        if len(self.queue) >= self.max_batches:
            raise RuntimeError("replica queue full (scheduler race)")
        if batch.arm not in self.models:
            raise KeyError(f"replica has no {batch.arm!r} model")
        self.queue.append(batch)

    def drain(self) -> list[_Batch]:
        """Give back the queued batches (used on eviction)."""
        out = list(self.queue)
        self.queue.clear()
        return out

    def tick(self) -> tuple[list[PredictResult], dict | None]:
        """Serve one queued batch; returns (results, shadow_stats|None)."""
        if not self.queue:
            return [], None
        batch = self.queue.popleft()
        x = np.stack([r.x_row for r in batch.requests]).astype(np.int32)
        labels = np.asarray(self.models[batch.arm](x))
        shadow_stats = None
        if self.shadow_fn is not None:
            mirrored = self.shadow_fn(x)
            if mirrored is not None:
                shadow_stats = {
                    "rows": int(len(labels)),
                    "disagree": int((np.asarray(mirrored) != labels).sum()),
                }
        results = [
            PredictResult(uid=r.uid, label=int(labels[j]), replica=-1,
                          batch_size=len(batch.requests), arm=batch.arm)
            for j, r in enumerate(batch.requests)]
        return results, shadow_stats


class BatchPredictService:
    """Front door: microbatched admission over a fleet of infer replicas."""

    def __init__(self, replicas: list, *, handle: ModelHandle | None = None,
                 policy: str | Policy = "ws", speed_fn=None,
                 max_batch: int = 64, max_wait_ticks: int = 4,
                 max_requeues: int = 2,
                 tracer: obs_trace.Tracer | None = None,
                 metrics: obs_metrics.Registry | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.replicas = replicas
        self.handle = handle
        self.policy = policy if isinstance(policy, Policy) \
            else make_policy(policy, speed_fn=speed_fn)
        self.max_batch = max_batch
        self.max_wait_ticks = max_wait_ticks
        self.max_requeues = max_requeues
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        reg = metrics if metrics is not None else obs_metrics.REGISTRY
        self._m_submitted = reg.counter(
            "infer_requests_total", "predict requests submitted")
        self._m_results = reg.counter(
            "infer_results_total", "predict requests served, by arm")
        self._m_failed = reg.counter(
            "infer_failures_total", "terminal predict failures, by reason")
        self._m_evictions = reg.counter(
            "infer_evictions_total", "infer replicas evicted")
        self._m_requeues = reg.counter(
            "infer_requeues_total", "requests re-admitted after a fault")
        self._m_batches = reg.counter(
            "infer_replica_batches_total", "batches served, by replica")
        self._m_batch_rows = reg.histogram(
            "infer_batch_rows", "rows per dispatched batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096))
        self._m_queue_wait = reg.histogram(
            "infer_queue_wait_ticks", "ticks from submit to first dispatch")
        self._m_shadow = reg.counter(
            "infer_shadow_mirrored_total", "rows mirrored to the shadow arm")
        self._m_shadow_disagree = reg.counter(
            "infer_shadow_disagree_total",
            "mirrored rows whose shadow label differed")
        self.healthy = [True] * len(replicas)
        #: per-arm pending queues of (request, submit_tick)
        self.pending: dict[str, deque] = {}
        self.ready: deque[_Batch] = deque()
        self.results: list[PredictResult] = []
        self.failed: list[PredictFailure] = []
        self._requeues: dict[int, int] = {}
        self._submit_tick: dict[int, int] = {}
        self._dispatched: dict[int, bool] = {}
        self._inflight = 0
        self._tick = 0

    # ------------------------------------------------------------ admission
    def submit(self, req: PredictRequest) -> None:
        arm = self.handle.route(req.uid) if self.handle else "stable"
        self._submit_tick.setdefault(req.uid, self._tick)
        self._m_submitted.inc()
        self.tracer.begin("predict", id=req.uid, arm=arm)
        self.pending.setdefault(arm, deque()).append((req, self._tick))
        self._inflight += 1

    def _close_batches(self) -> None:
        """Move pending requests into ready batches: full batches always,
        partial ones when the oldest request aged past ``max_wait_ticks``."""
        for arm, q in self.pending.items():
            while q:
                aged = (self._tick - q[0][1]) >= self.max_wait_ticks
                if len(q) < self.max_batch and not aged:
                    break
                take = min(len(q), self.max_batch)
                reqs = [q.popleft()[0] for _ in range(take)]
                self.ready.append(_Batch(arm=arm, requests=reqs))

    # ------------------------------------------------------------- failures
    def _fail(self, uid: int, reason: str, detail: str = "") -> None:
        self.failed.append(PredictFailure(uid, reason, detail))
        self._m_failed.inc(reason=reason)
        self.tracer.end("predict", id=uid, outcome=reason)
        self._inflight -= 1

    def _requeue_requests(self, batch: _Batch, detail: str) -> None:
        """Return a failed batch's rows to their pending queue (front),
        charging each request's requeue budget."""
        q = self.pending.setdefault(batch.arm, deque())
        for req in reversed(batch.requests):
            n = self._requeues.get(req.uid, 0)
            if n >= self.max_requeues:
                self._fail(req.uid, "requeue_exhausted", detail)
                continue
            self._requeues[req.uid] = n + 1
            self._m_requeues.inc()
            q.appendleft((req, self._submit_tick[req.uid]))

    def _evict(self, i: int, detail: str) -> None:
        if not self.healthy[i]:
            return
        self.healthy[i] = False
        self._m_evictions.inc()
        self.tracer.instant("infer.replica.evict", replica=i, detail=detail)
        try:
            orphans = self.replicas[i].drain()
        except Exception:
            orphans = []
        for batch in orphans:
            self._requeue_requests(batch, f"replica {i} evicted: {detail}")

    # ------------------------------------------------------------- dispatch
    def _dispatch(self) -> None:
        # Same masking discipline as serve.engine: the policy always sees
        # the full replica list, with evicted replicas as zero-capacity
        # views, so stateful policies address physical indices forever.
        while self.ready:
            if not any(self.healthy):
                return
            views = []
            for i, rep in enumerate(self.replicas):
                if not self.healthy[i]:
                    views.append(QueueState(tasks=0, weight=0.0, cap=0))
                else:
                    views.append(QueueState(tasks=rep.queue_len(),
                                            weight=rep.queued_weight(),
                                            cap=rep.capacity()))
            batch = self.ready[0]
            i = self.policy.pick(batch.weight, views)
            if i is None:
                return                      # every healthy replica full
            self.ready.popleft()
            try:
                self.replicas[i].admit(batch)
            except RuntimeError as e:
                self.ready.appendleft(batch)        # scheduler race
                self.tracer.instant("infer.batch.race", detail=repr(e))
                return
            except Exception as e:
                self._evict(i, f"admit raised: {e!r}")
                self.ready.appendleft(batch)
                continue
            self._m_batch_rows.observe(len(batch.requests))
            for req in batch.requests:
                if not self._dispatched.get(req.uid):
                    self._dispatched[req.uid] = True
                    self._m_queue_wait.observe(
                        self._tick - self._submit_tick[req.uid])
            self.tracer.instant("infer.batch.dispatch", replica=i,
                                rows=len(batch.requests), arm=batch.arm)

    # ------------------------------------------------------------- main loop
    def step(self) -> None:
        """One engine tick: close, dispatch, serve."""
        self._tick += 1
        with self.tracer.span("infer.tick", tick=self._tick):
            self._close_batches()
            self._dispatch()
            for i, rep in enumerate(self.replicas):
                if not self.healthy[i]:
                    continue
                try:
                    with self.tracer.span(f"infer.replica{i}.tick"):
                        results, shadow = rep.tick()
                except Exception as e:
                    self._evict(i, f"tick raised: {e!r}")
                    continue
                if results:
                    self._m_batches.inc(replica=i)
                if shadow:
                    self._m_shadow.inc(shadow["rows"])
                    self._m_shadow_disagree.inc(shadow["disagree"])
                for r in results:
                    r.replica = i
                    self.results.append(r)
                    self._m_results.inc(arm=r.arm)
                    self.tracer.end("predict", id=r.uid, outcome="ok")
                    self._inflight -= 1

    def run_until_drained(self, *, max_ticks: int = 10_000
                          ) -> list[PredictResult]:
        """Tick until every submitted request has a terminal record.

        Mirrors ``serve.engine``: results in ``self.results``, explicit
        failure records in ``self.failed`` — nothing is dropped silently,
        including at ``max_ticks`` or after losing the last replica.
        """
        for _ in range(max_ticks):
            if self._inflight == 0:
                break
            # Partial batches never deadlock a drain: the tick counter keeps
            # advancing, so every pending row ages past max_wait_ticks and
            # closes (step() -> _close_batches).
            self.step()
            if not any(self.healthy) and self._inflight:
                self._fail_remaining("no_replicas", "all replicas evicted")
                break
        if self._inflight:
            self._fail_remaining("max_ticks",
                                 f"undrained after {max_ticks} ticks")
        return self.results

    def _fail_remaining(self, reason: str, detail: str) -> None:
        for q in self.pending.values():
            while q:
                req, _ = q.popleft()
                self._fail(req.uid, reason, detail)
        while self.ready:
            for req in self.ready.popleft().requests:
                self._fail(req.uid, reason, detail)
        for i, rep in enumerate(self.replicas):
            try:
                for batch in rep.drain():
                    for req in batch.requests:
                        self._fail(req.uid, reason, detail)
            except Exception:
                continue
        self._inflight = 0

    # ------------------------------------------------------------------ misc
    def stats(self) -> dict[str, Any]:
        reasons: dict[str, int] = {}
        for f in self.failed:
            reasons[f.reason] = reasons.get(f.reason, 0) + 1
        return dict(
            ticks=self._tick,
            results=len(self.results),
            failed=len(self.failed),
            failed_by_reason=reasons,
            requeues=sum(self._requeues.values()),
            evicted_replicas=[i for i, h in enumerate(self.healthy) if not h],
            healthy_replicas=sum(self.healthy),
        )
