"""A supervised farm-with-feedback executor (FastFlow's D&C skeleton, Fig. 1/5).

Host-side, threaded implementation of the skeleton YaDT-FF is built on:

  * an *emitter* whose ``svc`` is called once with ``None`` at start-up and
    then once per task returned by a worker (the feedback channel);
  * ``n_workers`` *workers* whose ``svc`` processes one task and returns it;
  * per-worker bounded FIFO input queues + a MPSC feedback queue;
  * a pluggable scheduling policy (:mod:`repro_torch.core.scheduler`).

The emitter signals completion by the farm observing zero in-flight tasks
with an idle emitter — the threaded analogue of the paper's
``noMoreTasks() && !nChilds`` test (§6.10).

Unlike the paper's farm (which assumes workers never fail), this one is
**supervised**.  The run loop doubles as a supervisor that keeps the farm's
invariant — every dispatched task produces exactly one feedback event —
under worker crashes, hangs and deaths:

  * a ``worker_svc`` exception is captured and converted into an internal
    failure event; the task is retried on a surviving worker with bounded
    exponential backoff + jitter, and quarantined (surfaced to the emitter
    as a :class:`TaskFailure`) once it exhausts :class:`FaultPolicy` budget;
  * a per-attempt deadline (``FaultPolicy.task_deadline``) declares a hung
    worker dead and re-dispatches both its running task and its queued
    backlog to survivors; late results from a hung worker are dropped by
    attempt-tag matching;
  * a :class:`WorkerCrashed` exception kills the worker *thread* (the
    threaded analogue of a core going away); the farm degrades to fewer
    workers and fails the run — :class:`AllWorkersDead` — only when zero
    workers remain;
  * :meth:`Farm.run` returns the Fig-14 execution breakdown plus a failure
    breakdown (retries, requeues, quarantined tasks, timeouts, dead
    workers).

Deterministic failure modes for all of the above are injected by
:mod:`repro_torch.core.faults`.  :mod:`repro_torch.core.farm_build` grows
oracle-equal C4.5 trees through it and :mod:`repro_torch.ensemble.trainer`
whole forests, one tree a task.  A copy of the JAX package's
``core.farm``: the farm is host-side Python, and its workers are threads
that share one interpreter lock; the work they launch on the card runs
while they wait.
"""

from __future__ import annotations

import dataclasses
import heapq
import queue
import random
import threading
import time
from typing import Any, Callable

from repro_torch.core.scheduler import Policy, WS
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

GO_ON = object()   # FF_GO_ON: emitter consumed the feedback, keep running.

#: Thread-local set by the farm for the duration of each ``worker_svc``
#: call; ``WORKER_CTX.idx`` is the worker index.  Used by
#: :mod:`repro_torch.core.faults` to target specific workers without
#: changing the ``worker_svc`` signature.
WORKER_CTX = threading.local()


class WorkerCrashed(Exception):
    """Raising this from ``worker_svc`` kills the *worker*, not the task.

    The threaded analogue of a worker process/core dying: the thread exits
    its loop, the supervisor re-dispatches the worker's queued tasks to
    survivors, and the farm degrades to fewer workers.
    """


class AllWorkersDead(RuntimeError):
    """The farm has work outstanding but zero live workers remain."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Knobs for the farm's supervision layer (see README "Fault model").

    ``max_retries``       re-dispatches granted per task after its first
                          failed attempt; attempt ``max_retries + 1`` failing
                          quarantines the task.
    ``quarantine_after``  override: total failed attempts before quarantine
                          (defaults to ``max_retries + 1``).
    ``backoff_*``         exponential backoff between retry dispatches:
                          ``base * factor**(failures-1)`` capped at ``max``.
    ``jitter``            the delay is scaled by U[1-jitter, 1+jitter]
                          (seeded; decorrelates retry storms).
    ``task_deadline``     per-attempt wall-clock budget in seconds.  A worker
                          over deadline is declared hung-dead and its work
                          re-dispatched.  ``None`` disables timeouts.
    """

    max_retries: int = 3
    quarantine_after: int | None = None
    backoff_base: float = 0.005
    backoff_factor: float = 2.0
    backoff_max: float = 0.25
    jitter: float = 0.5
    task_deadline: float | None = None
    seed: int = 0

    def attempts_allowed(self) -> int:
        if self.quarantine_after is not None:
            return max(1, self.quarantine_after)
        return self.max_retries + 1

    def backoff(self, failures: int, rng: random.Random) -> float:
        """Delay before re-dispatch after the ``failures``-th failure."""
        if self.backoff_base <= 0:
            return 0.0
        raw = self.backoff_base * self.backoff_factor ** max(failures - 1, 0)
        raw = min(raw, self.backoff_max)
        lo, hi = max(0.0, 1.0 - self.jitter), 1.0 + self.jitter
        return raw * rng.uniform(lo, hi)


@dataclasses.dataclass
class TaskFailure:
    """Feedback record for a task that exhausted its retry budget.

    Delivered to the emitter in place of a worker result; the emitter may
    re-emit it, substitute a fallback, or ignore it (the farm also appends
    it to ``Farm.quarantined`` either way).
    """

    payload: Any
    weight: float
    failures: int
    error: str


@dataclasses.dataclass
class Task:
    payload: Any
    weight: float = 1.0
    label: str = "BUILD_NODE"


@dataclasses.dataclass
class _Pending:
    """Supervisor-side record of one in-flight (or backoff-waiting) task."""

    payload: Any
    weight: float
    attempt: int = 0          # tag of the attempt currently in flight
    failures: int = 0
    waiting_retry: bool = False


class _Worker:
    def __init__(self, idx: int, capacity: int):
        self.idx = idx
        self.q: queue.Queue = queue.Queue()   # bound enforced via _occupancy
        self._cap = capacity
        self._weight = 0.0
        self._occupancy = 0       # queued + running attempts (supervisor view)
        self._lock = threading.Lock()
        self.busy_time = 0.0
        self.n_tasks = 0
        self.alive = True
        # (task_id, attempt, started_at) of the attempt being executed now.
        self.current: tuple[int, int, float] | None = None

    # -- WorkerView protocol -------------------------------------------------
    def queue_len(self) -> int:
        with self._lock:
            return self._occupancy

    def queued_weight(self) -> float:
        with self._lock:
            return self._weight

    def capacity(self) -> int:
        return self._cap if self.alive else 0

    # -- accounting (supervisor + worker thread) -----------------------------
    # ``_occupancy`` counts *queued* attempts (capacity semantics, as the
    # original qsize-based farm); ``_weight`` counts queued + running work
    # (the WS policy's view).  ``begin`` moves an attempt queued -> running.
    def add_load(self, w: float) -> None:
        with self._lock:
            self._weight += w
            self._occupancy += 1

    def begin(self) -> None:
        with self._lock:
            self._occupancy -= 1

    def done_weight(self, w: float) -> None:
        with self._lock:
            self._weight -= w

    def drop_queued(self, w: float) -> None:
        with self._lock:
            self._weight -= w
            self._occupancy -= 1


class Farm:
    """``ff_farm<ws_scheduler>`` (paper Fig. 5) with a supervision layer."""

    def __init__(self, n_workers: int, *, policy: Policy | None = None,
                 queue_size: int = 4096, fault: FaultPolicy | None = None,
                 health: Any | None = None,
                 tracer: obs_trace.Tracer | None = None,
                 metrics: obs_metrics.Registry | None = None):
        if n_workers < 1:
            raise ValueError("farm needs at least one worker")
        self.health = health
        if policy is None and health is not None:
            policy = health.policy()
        self.policy = policy or WS()
        cap = getattr(self.policy, "forced_capacity", queue_size)
        self.workers = [_Worker(i, cap) for i in range(n_workers)]
        self.feedback: queue.Queue = queue.Queue()
        self.emitter_busy = 0.0
        self.fault = fault or FaultPolicy()
        self.quarantined: list[TaskFailure] = []
        self._rng = random.Random(self.fault.seed)
        self._stats = dict(failures=0, retries=0, requeues=0, timeouts=0,
                           quarantined=0, dropped_late=0)
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        reg = metrics if metrics is not None else obs_metrics.REGISTRY
        self._m_dispatch = reg.counter(
            "farm_dispatch_total", "task attempts placed on worker queues")
        self._m_done = reg.counter(
            "farm_tasks_done_total", "task attempts completed ok")
        self._m_events = reg.counter(
            "farm_events_total", "supervision events, by event= label")
        self._m_task_s = reg.histogram(
            "farm_task_seconds", "worker_svc wall time per attempt")
        self._m_qweight = reg.gauge(
            "farm_queued_weight", "per-worker queued+running WS weight")

    def _bump(self, key: str) -> None:
        """One supervision event: mirror ``_stats`` into the metrics."""
        self._stats[key] += 1
        self._m_events.inc(event=key)

    # ------------------------------------------------------------------ run
    def run(self,
            emitter_svc: Callable[[Any, Callable[[Any, float], None]], Any],
            worker_svc: Callable[[Any], Any]) -> dict[str, Any]:
        """Run to completion; returns execution + failure breakdown stats."""
        stop = object()
        pending: dict[int, _Pending] = {}
        retry_heap: list[tuple[float, int]] = []   # (due_time, task_id)
        deferred: list = []          # non-death feedback taken while spinning
        notify: list[TaskFailure] = []   # quarantines awaiting the emitter
        next_id = iter(range(1 << 62)).__next__

        # ---------------- dispatch path ------------------------------------
        def alive(self=self) -> list[_Worker]:
            return [w for w in self.workers if w.alive]

        def poll_deaths() -> None:
            """Absorb worker-death events while the dispatch path is blocked.

            ``send_out`` may spin on full queues *inside* the emitter, before
            the main loop can read feedback; a worker dying then must still
            be noticed or the spin never ends.  Other feedback is deferred
            to the main loop untouched.
            """
            while True:
                try:
                    m = self.feedback.get_nowait()
                except queue.Empty:
                    return
                if m[0] == "died":
                    handle_died(m)
                else:
                    deferred.append(m)

        def dispatch(task_id: int) -> None:
            """Place the pending attempt on a live worker's queue."""
            rec = pending[task_id]
            rec.waiting_retry = False
            while True:
                i = self.policy.pick(rec.weight, self.workers)
                if i is not None and self.workers[i].alive:
                    break
                poll_deaths()
                if not alive():
                    raise AllWorkersDead(
                        f"{len(pending)} task(s) outstanding, 0 live workers")
                # all live queues full: let deadlines fire, yield and retry
                self._check_deadlines(on_worker_death)
                time.sleep(1e-4)
            wk = self.workers[i]
            wk.add_load(rec.weight)
            wk.q.put((task_id, rec.attempt, rec.payload, rec.weight))
            self._m_dispatch.inc()
            qw = wk.queued_weight()
            self._m_qweight.set(qw, worker=i)
            self.tracer.instant("task.dispatch", task=task_id,
                                attempt=rec.attempt, worker=i,
                                weight=rec.weight)
            self.tracer.counter(f"w{i}.queued_weight", weight=qw)

        def send_out(payload: Any, weight: float = 1.0) -> None:
            task_id = next_id()
            pending[task_id] = _Pending(payload=payload, weight=weight)
            dispatch(task_id)

        # ---------------- failure path -------------------------------------
        def on_failure(task_id: int, err: str) -> None:
            rec = pending[task_id]
            rec.failures += 1
            self._bump("failures")
            if rec.failures >= self.fault.attempts_allowed():
                del pending[task_id]
                fail = TaskFailure(payload=rec.payload, weight=rec.weight,
                                   failures=rec.failures, error=err)
                self.quarantined.append(fail)
                self._bump("quarantined")
                self.tracer.instant("task.quarantine", task=task_id,
                                    failures=rec.failures, error=err)
                notify.append(fail)      # delivered outside the dispatch path
                return
            self._bump("retries")
            rec.attempt += 1
            rec.waiting_retry = True
            delay = self.fault.backoff(rec.failures, self._rng)
            self.tracer.instant("task.retry", task=task_id,
                                failures=rec.failures, backoff_s=delay)
            heapq.heappush(retry_heap, (time.monotonic() + delay, task_id))

        def handle_died(msg) -> None:
            _, task_id, attempt, widx, err = msg
            on_worker_death(self.workers[widx], err)
            rec = pending.get(task_id)
            if rec is not None and rec.attempt == attempt \
                    and not rec.waiting_retry:
                on_failure(task_id, err)

        def on_worker_death(wk: _Worker, why: str) -> None:
            """Drain a dead worker: requeue its backlog, fail its current."""
            if not wk.alive:
                return
            wk.alive = False
            self._m_events.inc(event="worker_death")
            self.tracer.instant("worker.death", worker=wk.idx, why=why)
            if self.health is not None:
                self.health.on_worker_dead(wk.idx)
            cur = wk.current
            wk.current = None
            # Re-dispatch queued (never-started) attempts: not the task's
            # fault, so requeue without consuming retry budget.
            while True:
                try:
                    item = wk.q.get_nowait()
                except queue.Empty:
                    break
                if item is stop:
                    continue
                task_id, attempt, _, weight = item
                wk.drop_queued(weight)
                rec = pending.get(task_id)
                if rec is None or rec.attempt != attempt:
                    continue
                self._bump("requeues")
                self.tracer.instant("task.requeue", task=task_id,
                                    worker=wk.idx)
                dispatch(task_id)
            if cur is not None:
                task_id, attempt, _ = cur
                rec = pending.get(task_id)
                if rec is not None and rec.attempt == attempt \
                        and not rec.waiting_retry:
                    wk.done_weight(rec.weight)
                    on_failure(task_id, why)

        # ---------------- worker threads ------------------------------------
        def worker_loop(wk: _Worker) -> None:
            WORKER_CTX.idx = wk.idx
            while True:
                item = wk.q.get()
                if item is stop:
                    return
                task_id, attempt, payload, weight = item
                wk.begin()
                wk.current = (task_id, attempt, time.perf_counter())
                t0 = time.perf_counter()
                try:
                    with self.tracer.span("task", task=task_id,
                                          attempt=attempt, worker=wk.idx):
                        result = worker_svc(payload)
                except WorkerCrashed as e:
                    wk.current = None
                    wk.done_weight(weight)
                    self.feedback.put(
                        ("died", task_id, attempt, wk.idx, repr(e)))
                    return                      # thread exits: worker is gone
                except BaseException as e:      # crash -> failure feedback
                    wk.current = None
                    wk.done_weight(weight)
                    self.feedback.put(
                        ("fail", task_id, attempt, wk.idx, repr(e)))
                    continue
                dt = time.perf_counter() - t0
                wk.current = None
                wk.busy_time += dt
                wk.n_tasks += 1
                if wk.alive:      # hung-declared-dead: supervisor settled it
                    wk.done_weight(weight)
                self.feedback.put(("ok", task_id, attempt, wk.idx, result, dt))

        # ---------------- emitter ------------------------------------------
        def run_emitter(task: Any) -> None:
            t0 = time.perf_counter()
            with self.tracer.span("emitter"):
                emitter_svc(task, send_out)
            self.emitter_busy += time.perf_counter() - t0

        threads = [threading.Thread(target=worker_loop, args=(w,), daemon=True)
                   for w in self.workers]
        for t in threads:
            t.start()

        def flush_notify() -> None:
            while notify:
                run_emitter(notify.pop(0))

        try:
            run_emitter(None)                    # start-up call (§6.2)
            flush_notify()
            while pending:
                now = time.monotonic()
                while retry_heap and retry_heap[0][0] <= now:
                    _, task_id = heapq.heappop(retry_heap)
                    if task_id in pending and pending[task_id].waiting_retry:
                        dispatch(task_id)
                if deferred:
                    msg = deferred.pop(0)
                else:
                    timeout = self._poll_timeout(retry_heap, now)
                    try:
                        msg = self.feedback.get(timeout=timeout)
                    except queue.Empty:
                        self._check_deadlines(on_worker_death)
                        flush_notify()
                        continue
                kind, task_id, attempt, widx = msg[:4]
                if kind == "died":
                    # The thread is gone no matter how stale the attempt tag.
                    handle_died(msg)
                else:
                    rec = pending.get(task_id)
                    if rec is None or rec.attempt != attempt \
                            or rec.waiting_retry:
                        self._bump("dropped_late")        # superseded attempt
                    elif kind == "ok":
                        result, dt = msg[4], msg[5]
                        if self.health is not None:
                            self.health.on_task(widx, dt)
                        self._m_done.inc()
                        self._m_task_s.observe(dt)
                        qw = self.workers[widx].queued_weight()
                        self._m_qweight.set(qw, worker=widx)
                        self.tracer.counter(f"w{widx}.queued_weight",
                                            weight=qw)
                        del pending[task_id]
                        run_emitter(result)
                    else:                          # "fail"
                        on_failure(task_id, msg[4])
                flush_notify()
                if not alive() and pending:
                    raise AllWorkersDead(
                        f"{len(pending)} task(s) outstanding, 0 live workers")
        finally:
            for w in self.workers:
                if w.alive:
                    w.q.put(stop)
            for w, t in zip(self.workers, threads):
                t.join(timeout=None if w.alive else 0.1)
        return self.stats()

    # ---------------------------------------------------------------- utils
    def _poll_timeout(self, retry_heap, now: float) -> float | None:
        """Block on feedback only as long as no deadline/retry needs service."""
        candidates = []
        if retry_heap:
            candidates.append(max(0.0, retry_heap[0][0] - now))
        ddl = self.fault.task_deadline
        if ddl is not None:
            candidates.append(max(ddl / 4.0, 1e-3))
        return min(candidates) if candidates else None

    def _check_deadlines(self, on_worker_death) -> None:
        ddl = self.fault.task_deadline
        if ddl is None:
            return
        now = time.perf_counter()
        for wk in self.workers:
            cur = wk.current
            if wk.alive and cur is not None and now - cur[2] > ddl:
                self._bump("timeouts")
                self.tracer.instant("worker.timeout", worker=wk.idx)
                on_worker_death(
                    wk, f"deadline: worker {wk.idx} over {ddl:.3f}s budget")

    def stats(self) -> dict[str, Any]:
        """Fig-14 execution breakdown + supervision failure breakdown."""
        return dict(
            emitter_busy=self.emitter_busy,
            worker_busy=[w.busy_time for w in self.workers],
            worker_tasks=[w.n_tasks for w in self.workers],
            dead_workers=[w.idx for w in self.workers if not w.alive],
            n_live_workers=sum(w.alive for w in self.workers),
            **self._stats,
        )
