"""The port's supervised farm, its scheduling policies, fault injection
and health wiring, and the kernel wrappers' thread safety.

The farm and scheduler cases of ``tests/test_farm.py`` (not the
simulator) and every case of ``tests/test_faults.py`` run through
``repro_torch`` (the farm is host Python: these need no device).  Every
test that exercises a termination guarantee runs under
``run_with_timeout``, so a supervision regression *fails* instead of
hanging.  ``FaultInjector.decide`` must give the JAX package's schedule for
the same seed and key.  The kernel wrappers' launch counters must stay
exact under 8 threads, and ``_build.library`` must build a kernel once
when 4 threads first reach it together.
"""

import os
import threading
import time

import pytest

from conftest import run_with_timeout
from repro.core import faults as jfaults
from repro_torch.core import faults
from repro_torch.core.farm import (AllWorkersDead, Farm, FaultPolicy,
                                   TaskFailure, WorkerCrashed)
from repro_torch.core.scheduler import (DRR, OD, WS, HealthWS, QueueState,
                                        make_policy)
from repro_torch.train import elastic
from repro_torch.train.elastic import (FarmHealth, HeartbeatMonitor,
                                       StragglerMonitor)

pytestmark = pytest.mark.timeout(120)


def range_emitter(n):
    """Emitter that floods n tasks at start-up and collects results."""
    seen = []

    def emitter(task, send):
        if task is None:
            for i in range(n):
                send(i, weight=float(i + 1))
        else:
            seen.append(task)
    return emitter, seen


def results(seen):
    return sorted(x for x in seen if not isinstance(x, TaskFailure))


# ---------------------------------------------------------------------------
# deadlock regressions (satellite: the original farm hung on any exception)
# ---------------------------------------------------------------------------

def test_worker_exception_does_not_deadlock_run():
    """A crashing worker_svc must terminate the run, not hang feedback.get."""
    emitter, seen = range_emitter(10)

    def svc(x):
        if x == 4:
            raise ValueError("boom")
        return x

    farm = Farm(3, fault=FaultPolicy(max_retries=1, backoff_base=0.0))
    stats = run_with_timeout(lambda: farm.run(emitter, svc), 30)
    assert results(seen) == [x for x in range(10) if x != 4]
    assert stats["quarantined"] == 1
    assert stats["failures"] == 2          # initial attempt + 1 retry
    assert farm.quarantined[0].payload == 4


def test_send_out_aborts_when_all_workers_dead():
    """The full-queue spin in send_out must raise, not spin forever."""
    def svc(x):
        raise WorkerCrashed("gone")

    def emitter(task, send):
        if task is None:
            for i in range(10):
                send(i)

    farm = Farm(1, policy=OD(), fault=FaultPolicy(max_retries=3))
    with pytest.raises(AllWorkersDead):
        run_with_timeout(lambda: farm.run(emitter, svc), 30)


def test_zero_live_workers_raises_with_tasks_outstanding():
    emitter, _ = range_emitter(5)
    farm = Farm(2, fault=FaultPolicy(max_retries=4))
    with pytest.raises(AllWorkersDead):
        run_with_timeout(
            lambda: farm.run(emitter, lambda x: (_ for _ in ()).throw(
                WorkerCrashed("dead"))), 30)


# ---------------------------------------------------------------------------
# retry / backoff / quarantine
# ---------------------------------------------------------------------------

def test_retry_recovers_transient_crashes():
    attempts = {}
    lock = threading.Lock()

    def svc(x):
        with lock:
            attempts[x] = attempts.get(x, 0) + 1
            if attempts[x] == 1 and x % 3 == 0:
                raise RuntimeError(f"transient {x}")
        return x

    emitter, seen = range_emitter(12)
    farm = Farm(4, fault=FaultPolicy(max_retries=2, backoff_base=1e-4))
    stats = run_with_timeout(lambda: farm.run(emitter, svc), 30)
    assert results(seen) == list(range(12))
    assert stats["retries"] == 4           # 0, 3, 6, 9
    assert stats["quarantined"] == 0


def test_quarantine_after_budget_and_emitter_notified():
    emitter_fail = []

    def emitter(task, send):
        if task is None:
            send("poison")
            send("fine")
        elif isinstance(task, TaskFailure):
            emitter_fail.append(task)

    def svc(x):
        if x == "poison":
            raise RuntimeError("always")
        return x

    farm = Farm(2, fault=FaultPolicy(max_retries=2, quarantine_after=2,
                                     backoff_base=0.0))
    stats = run_with_timeout(lambda: farm.run(emitter, svc), 30)
    assert stats["quarantined"] == 1
    assert stats["failures"] == 2          # quarantine_after overrides
    assert emitter_fail[0].payload == "poison"
    assert "always" in emitter_fail[0].error


def test_backoff_is_bounded_and_jittered():
    import random
    pol = FaultPolicy(backoff_base=0.01, backoff_factor=2.0, backoff_max=0.05,
                      jitter=0.5)
    rng = random.Random(0)
    delays = [pol.backoff(k, rng) for k in range(1, 12)]
    assert all(0 < d <= 0.05 * 1.5 for d in delays)
    assert delays[1] != delays[2]          # jitter decorrelates
    assert FaultPolicy(backoff_base=0.0).backoff(3, rng) == 0.0


# ---------------------------------------------------------------------------
# deadlines (hung workers) and worker death
# ---------------------------------------------------------------------------

def test_deadline_declares_hung_worker_dead_and_redispatches():
    hung = threading.Event()

    def svc(x):
        if x == 5 and not hung.is_set():
            hung.set()
            time.sleep(3.0)                # >> deadline
        return x * 10

    emitter, seen = range_emitter(8)
    farm = Farm(3, fault=FaultPolicy(task_deadline=0.25, max_retries=3,
                                     backoff_base=1e-4))
    stats = run_with_timeout(lambda: farm.run(emitter, svc), 30)
    assert results(seen) == [x * 10 for x in range(8)]
    assert stats["timeouts"] >= 1
    assert len(stats["dead_workers"]) == 1


def test_worker_death_requeues_its_backlog():
    inj = faults.FaultInjector(seed=0, spec=faults.FaultSpec(
        dead_workers=frozenset({0})))
    emitter, seen = range_emitter(30)
    farm = Farm(3, fault=FaultPolicy(max_retries=2))
    stats = run_with_timeout(
        lambda: farm.run(emitter, inj.wrap_worker(lambda x: x)), 30)
    assert results(seen) == list(range(30))
    assert stats["dead_workers"] == [0]
    assert stats["n_live_workers"] == 2


def test_stats_expose_failure_breakdown():
    emitter, _ = range_emitter(4)
    farm = Farm(2)
    stats = run_with_timeout(lambda: farm.run(emitter, lambda x: x), 30)
    for key in ("failures", "retries", "requeues", "timeouts", "quarantined",
                "dead_workers", "n_live_workers", "emitter_busy",
                "worker_busy", "worker_tasks"):
        assert key in stats
    assert stats["failures"] == 0
    assert sum(stats["worker_tasks"]) == 4


# ---------------------------------------------------------------------------
# deterministic injection harness
# ---------------------------------------------------------------------------

def test_injector_is_deterministic_across_runs():
    spec = faults.FaultSpec(crash_p=0.3, die_p=0.1, hang_p=0.05, slow_p=0.2)
    a = faults.FaultInjector(seed=42, spec=spec)
    b = faults.FaultInjector(seed=42, spec=spec)
    keys = [(k, c) for k in range(50) for c in range(3)]
    assert [a.decide(k, c) for k, c in keys] == \
        [b.decide(k, c) for k, c in keys]
    c = faults.FaultInjector(seed=43, spec=spec)
    assert [a.decide(k, c_) for k, c_ in keys] != \
        [c.decide(k, c_) for k, c_ in keys]


def test_injector_rates_roughly_match_probabilities():
    spec = faults.FaultSpec(crash_p=0.25)
    inj = faults.FaultInjector(seed=1, spec=spec)
    n = 2000
    crashes = sum(inj.decide(k, 0) == "crash" for k in range(n))
    assert 0.18 < crashes / n < 0.32


def test_injector_probabilities_must_be_sane():
    with pytest.raises(ValueError):
        faults.FaultSpec(crash_p=0.7, hang_p=0.5)


# ---------------------------------------------------------------------------
# elastic wiring: heartbeat + straggler weights into the scheduling path
# ---------------------------------------------------------------------------

def test_health_ws_biases_away_from_stragglers():
    health = FarmHealth(2)
    for _ in range(8):
        health.on_task(0, 1.0)    # w0: slow
        health.on_task(1, 0.1)    # w1: fast
    pol = health.policy()
    views = [QueueState(tasks=0, weight=1.0, cap=8),
             QueueState(tasks=0, weight=2.0, cap=8)]
    # plain WS would pick 0 (lower raw weight); health-WS picks the fast one
    assert WS().pick(1.0, views) == 0
    assert pol.pick(1.0, views) == 1


def test_health_ws_skips_dead_and_heartbeat_failed_workers():
    hb = HeartbeatMonitor(timeout=10.0)
    health = FarmHealth(3, heartbeat=hb)
    health.on_task(0, 0.1, now=0.0)
    health.on_task(1, 0.1, now=100.0)      # w0 is now 100s silent -> failed
    health.on_worker_dead(2)
    speeds = health.speeds(now=100.0)
    assert speeds[0] == 0.0 and speeds[2] == 0.0 and speeds[1] > 0
    pol = HealthWS(lambda: speeds)
    views = [QueueState(0, 0.0, 8), QueueState(5, 50.0, 8),
             QueueState(0, 0.0, 8)]
    assert pol.pick(1.0, views) == 1       # only healthy candidate wins
    # ...but if every healthy queue is full, fall back to raw WS capacity
    views_full = [QueueState(0, 0.0, 8), QueueState(8, 50.0, 8),
                  QueueState(0, 0.0, 8)]
    assert pol.pick(1.0, views_full) in (0, 2)


def test_farm_feeds_health_monitors():
    health = FarmHealth(2)
    emitter, seen = range_emitter(10)
    farm = Farm(2, health=health)
    run_with_timeout(lambda: farm.run(emitter, lambda x: x), 30)
    assert isinstance(farm.policy, HealthWS)
    assert results(seen) == list(range(10))
    assert set(health.straggler.times) <= {"w0", "w1"}
    assert len(health.heartbeat.hosts) >= 1


def test_farm_reports_dead_worker_to_health():
    health = FarmHealth(2)
    inj = faults.FaultInjector(seed=0, spec=faults.FaultSpec(
        dead_workers=frozenset({1})))
    emitter, seen = range_emitter(12)
    farm = Farm(2, health=health, fault=FaultPolicy(max_retries=2))
    run_with_timeout(
        lambda: farm.run(emitter, inj.wrap_worker(lambda x: x)), 30)
    assert health.dead == {1}
    assert health.speeds()[1] == 0.0
    assert results(seen) == list(range(12))


# ---------------------------------------------------------------------------
# tests/test_farm.py: policies and the feedback channel
# ---------------------------------------------------------------------------

def views(specs):
    return [QueueState(tasks=t, weight=w, cap=c) for t, w, c in specs]


def test_ws_picks_least_weight():
    assert WS().pick(5, views([(1, 10, 4), (2, 3, 4), (1, 7, 4)])) == 1


def test_ws_skips_full_queues():
    ws = WS()
    assert ws.pick(5, views([(4, 0, 4), (2, 99, 4)])) == 1
    assert ws.pick(5, views([(4, 0, 4), (4, 0, 4)])) is None


def test_drr_round_robin_skips_full():
    drr = DRR()
    assert drr.pick(1, views([(0, 0, 4), (0, 0, 4)])) == 0
    assert drr.pick(1, views([(0, 0, 4), (0, 0, 4)])) == 1
    assert drr.pick(1, views([(4, 0, 4), (0, 0, 4)])) == 1


def test_od_is_capacity_one():
    assert make_policy("od").forced_capacity == 1


def test_farm_feedback_conservation():
    """Every emitted task returns exactly once through the feedback channel."""
    seen = []

    def emitter(task, send):
        if task is None:
            for i in range(25):
                send(i, weight=float(i + 1))
        else:
            seen.append(task)
            if task % 7 == 0 and task > 0 and task < 20:
                send(task + 100, weight=1.0)   # D&C: children from feedback

    farm = Farm(4, policy=WS())
    stats = run_with_timeout(lambda: farm.run(emitter, lambda x: x), 30)
    expect = 25 + len([t for t in range(25) if t % 7 == 0 and 0 < t < 20])
    assert len(seen) == expect
    assert sum(stats["worker_tasks"]) == expect


def test_cost_models_monotone_in_r():
    from repro_torch.core.cost_models import build_att_test
    for model in ("alpha", "nlogn", "nsq"):
        prev = False
        for r in (10, 100, 1000, 10_000, 100_000):
            cur = bool(build_att_test(model, n_total_cases=50_000.0,
                                      r=float(r), c=8.0))
            assert cur >= prev    # once True, stays True (paper property)
            prev = cur


# tests/test_elastic.py's straggler case (the farm's health input)
def test_straggler_detection_and_ws_weights():
    sm = elastic.StragglerMonitor(factor=1.5)
    for _ in range(8):
        sm.record("fast0", 1.0)
        sm.record("fast1", 1.1)
        sm.record("slow", 2.5)
    assert sm.stragglers() == ["slow"]
    w = sm.ws_weights()
    assert w["slow"] < w["fast0"]          # slow host gets less work


# ---------------------------------------------------------------------------
# the fault schedule is the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 11])
def test_injector_decides_as_the_jax_package(seed):
    spec_kw = dict(crash_p=0.2, die_p=0.1, hang_p=0.05, slow_p=0.15)
    mine = faults.FaultInjector(seed=seed, spec=faults.FaultSpec(**spec_kw))
    ref = jfaults.FaultInjector(seed=seed,
                                spec=jfaults.FaultSpec(**spec_kw))
    pairs = [(k, c) for k in range(50) for c in range(4)]        # 200
    got = [mine.decide(k, c) for k, c in pairs]
    assert got == [ref.decide(k, c) for k, c in pairs]
    assert len(set(got)) == 5              # every action drawn


# ---------------------------------------------------------------------------
# kernel launches from the farm's threads (no device: counts and the build)
# ---------------------------------------------------------------------------

def _hammer(fn, calls=2_000):
    """``calls`` calls of ``fn`` from each of 8 threads (more where the
    machine has more cores); the number made."""
    n_threads = max(8, (os.cpu_count() or 1) + 1)
    start = threading.Barrier(n_threads)

    def run():
        start.wait()
        for _ in range(calls):
            fn()
    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return n_threads * calls


@pytest.mark.parametrize("module,counter,plans,key", [
    ("histogram", "LAUNCHES", "PLANS", "direct"),
    ("split_gain", "LAUNCHES", None, None),
    ("split_post", "LAUNCHES", None, None),
    ("tree_infer", "LAUNCHES", "PLANS", "spread"),
    ("flash_attention", "LAUNCHES", "LAUNCHES_BY_DTYPE", "bfloat16"),
])
def test_launch_counts_exact_under_threads(module, counter, plans, key,
                                           monkeypatch):
    import importlib
    import sys
    from repro_torch.kernels import _build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    lib = getattr(mod, "_LIB", None) or mod._FWD     # flash: the forward's
    assert (lib.total, lib.by) == (counter, plans)
    monkeypatch.setattr(mod, counter, 0)
    if plans:
        monkeypatch.setattr(mod, plans, dict(getattr(mod, plans)))
        getattr(mod, plans)[key] = 0
    # a thread switch every microsecond makes a lost update likely
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n = _hammer(lambda: _build.count(lib, key))
    finally:
        sys.setswitchinterval(old)
    assert getattr(mod, counter) == n
    if plans:
        assert getattr(mod, plans)[key] == n
    # the update is the lock's: a count waits while another thread holds it
    bump = threading.Thread(target=lambda: _build.count(lib, key))
    with _build._COUNT_LOCK:
        bump.start()
        bump.join(0.2)
        assert bump.is_alive() and getattr(mod, counter) == n
    bump.join(30)
    assert not bump.is_alive() and getattr(mod, counter) == n + 1


def test_library_builds_once_under_threads(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    builds = []

    def slow_build(names=_build.KERNELS):
        builds.append(tuple(names))
        time.sleep(0.2)                       # nvcc's seconds, shortened
        for n in names:
            _build.library_path(n).write_bytes(b"")
        return {}
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    got = []
    start = threading.Barrier(4)

    def first_use():
        start.wait()
        got.append(_build.library("histogram"))
    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert builds == [("histogram",)]
    assert len(set(got)) == 1 and len(got) == 4
