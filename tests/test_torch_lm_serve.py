"""The port's serving engine against the JAX package's, on the CPU.

The scenarios of ``tests/test_serve.py``, ``tests/test_engine_policies.py``
and ``tests/test_engine_failover.py``, each written once and run on both
packages: one reduced yi_6b in f32 (the JAX ``init`` weights carried into
the port by ``params_from_jax``) for the model-backed ones (five of them
also on reduced phi35_moe, recurrentgemma_2b and rwkv6_3b), a model-free
``FakeReplica`` for the policy ones.  Completions must equal the JAX
engine's token for token (greedy decoding over f32 logits that agree to
about 1e-5, far inside the gaps between the top logits), and ``stats()``,
failure records, metric snapshots and trace events (without their clock)
must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import faults as jfaults
from repro.models import model as jmodel
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve import engine as jengine
from repro.serve import sampling as jsampling
from repro.train import elastic as jelastic
from repro_torch.configs import base as tbase
from repro_torch.core import faults as tfaults
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serve import engine as tengine
from repro_torch.serve import sampling as tsampling
from repro_torch.train import elastic as telastic

pytestmark = pytest.mark.timeout(600)


class Side:
    """One package's serving classes around the shared weights."""

    def __init__(self, name, engine, chaos, heartbeat, registry, tracer,
                 replica, vocab):
        self.name, self.engine, self.chaos = name, engine, chaos
        self.heartbeat, self.registry, self.tracer = heartbeat, registry, \
            tracer
        self.replica, self.vocab = replica, vocab

    def request(self, uid, prompt, **kw):
        return self.engine.Request(uid=uid, prompt=prompt, **kw)

    def serving(self, replicas, **kw):
        return self.engine.ServingEngine(replicas, **kw)


@functools.lru_cache(maxsize=None)
def arch_sides(arch):
    """Both packages' serving classes around the shared weights of reduced
    ``arch`` in f32."""
    cj = jbase.reduced(jbase.get_config(arch), dtype="float32")
    ct = tbase.reduced(tbase.get_config(arch), dtype="float32")
    mj = jmodel.build_model(cj)
    pj = mj.init(jax.random.key(0))
    mt = tmodel.build_model(ct)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    return (
        Side("jax", jengine, jfaults.ChaosReplica, jelastic.HeartbeatMonitor,
             jmetrics.Registry, jtrace.Tracer,
             lambda **kw: jengine.Replica(mj, pj, **kw), cj.vocab_size),
        Side("torch", tengine, tfaults.ChaosReplica,
             telastic.HeartbeatMonitor, tmetrics.Registry, ttrace.Tracer,
             lambda **kw: tengine.Replica(mt, pt, device="cpu", **kw),
             ct.vocab_size))


@pytest.fixture(scope="module")
def sides():
    return arch_sides("yi_6b")


def _record(eng, *, metrics=None, tracer=None) -> dict:
    """Everything an engine run shows its caller."""
    out = dict(
        completed=[(c.uid, list(c.tokens)) for c in eng.completed],
        failed=[(f.uid, f.reason, f.detail, list(f.tokens))
                for f in eng.failed],
        stats=eng.stats(), healthy=list(eng.healthy))
    if metrics is not None:
        out["metrics"] = metrics.snapshot()
    if tracer is not None:
        drop = {"ts", "dur", "pid", "tid"}
        out["trace"] = [{k: v for k, v in ev.items() if k not in drop}
                        for ev in tracer.events]
    return out


def _prompts(vocab, n, *, seed, lo=4, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(lo, hi))).astype(
        np.int32) for _ in range(n)]


# --------------------------------------------------------------------------
# model-backed scenarios (tests/test_serve.py, tests/test_engine_failover.py)
# --------------------------------------------------------------------------

def sc_manual_greedy(side):
    prompt = np.random.default_rng(0).integers(1, side.vocab, 12).astype(
        np.int32)
    eng = side.serving([side.replica(n_slots=2, max_seq=64)])
    eng.submit(side.request(0, prompt, max_new_tokens=5))
    eng.run_until_drained()
    return _record(eng)


def sc_mixed_lengths(side):
    rng = np.random.default_rng(1)
    reg, tr = side.registry(), side.tracer()
    eng = side.serving([side.replica(n_slots=3, max_seq=96)], metrics=reg,
                       tracer=tr)
    for i in range(7):
        eng.submit(side.request(
            i, rng.integers(1, side.vocab, int(rng.integers(3, 40))
                            ).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 6))))
    eng.run_until_drained()
    return _record(eng, metrics=reg, tracer=tr)


def sc_isolated_slots(side):
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, side.vocab, 9).astype(np.int32)
    solo = side.serving([side.replica(n_slots=4, max_seq=64)])
    solo.submit(side.request(0, prompt, max_new_tokens=4))
    solo.run_until_drained()
    crowd = side.serving([side.replica(n_slots=4, max_seq=64)])
    crowd.submit(side.request(9, rng.integers(1, side.vocab, 20).astype(
        np.int32), max_new_tokens=6))
    crowd.submit(side.request(0, prompt, max_new_tokens=4))
    crowd.run_until_drained()
    outs = {c.uid: c.tokens for c in crowd.completed}
    assert outs[0] == solo.completed[0].tokens
    return [_record(solo), _record(crowd)]


def sc_ws_two_replicas(side):
    rng = np.random.default_rng(3)
    reps = [side.replica(n_slots=4, max_seq=64) for _ in range(2)]
    eng = side.serving(reps, policy="ws")
    for i in range(8):
        eng.submit(side.request(i, rng.integers(1, side.vocab, 10).astype(
            np.int32), max_new_tokens=3))
    eng._admit_backlog()
    queued = [r.queue_len() for r in reps]
    assert min(queued) > 0
    eng.run_until_drained()
    return dict(queued=queued, **_record(eng))


def sc_killed_mid_run(side):
    reg = side.registry()
    victim = side.chaos(side.replica(n_slots=2, max_seq=64), fail_at_tick=2)
    eng = side.serving([victim, side.replica(n_slots=2, max_seq=64)],
                       max_requeues=2, metrics=reg)
    for i, p in enumerate(_prompts(side.vocab, 6, seed=0)):
        eng.submit(side.request(i, p, max_new_tokens=4))
    eng.run_until_drained(max_ticks=500)
    assert eng.healthy == [False, True] and len(eng.completed) == 6
    return _record(eng, metrics=reg)


def sc_all_replicas_dead(side):
    rep = side.chaos(side.replica(n_slots=2, max_seq=64), fail_at_tick=1)
    eng = side.serving([rep])
    for i, p in enumerate(_prompts(side.vocab, 4, seed=0)):
        eng.submit(side.request(i, p, max_new_tokens=4))
    assert eng.run_until_drained(max_ticks=200) == []
    return _record(eng)


def sc_admit_race(side):
    rep = side.chaos(side.replica(n_slots=2, max_seq=64), admit_failures=1)
    eng = side.serving([rep], max_requeues=3)
    for i, p in enumerate(_prompts(side.vocab, 3, seed=0)):
        eng.submit(side.request(i, p, max_new_tokens=4))
    eng.run_until_drained(max_ticks=300)
    return _record(eng)


def sc_deadline(side):
    eng = side.serving([side.replica(n_slots=2, max_seq=128)])
    prompt = np.random.default_rng(1).integers(1, side.vocab, 8).astype(
        np.int32)
    eng.submit(side.request(0, prompt, max_new_tokens=64, deadline_ticks=3))
    eng.submit(side.request(1, prompt, max_new_tokens=2))
    eng.run_until_drained(max_ticks=300)
    (fail,) = eng.failed
    assert (fail.uid, fail.reason) == (0, "timeout")
    return _record(eng)


def sc_max_ticks(side):
    eng = side.serving([side.replica(n_slots=1, max_seq=64)])
    for i, p in enumerate(_prompts(side.vocab, 3, seed=0)):
        eng.submit(side.request(i, p, max_new_tokens=8))
    eng.run_until_drained(max_ticks=2)
    return _record(eng)


def sc_heartbeat(side):
    reg = side.registry()
    hb = side.heartbeat(timeout=5, metrics=reg)
    reps = [side.replica(n_slots=2, max_seq=64) for _ in range(2)]
    eng = side.serving(reps, heartbeat=hb, max_requeues=2, metrics=reg)
    hb.beat("replica0", now=-100)
    for i, p in enumerate(_prompts(side.vocab, 4, seed=0)):
        eng.submit(side.request(i, p, max_new_tokens=4))
    eng.run_until_drained(max_ticks=500)
    assert eng.healthy == [False, True]
    return _record(eng, metrics=reg)


def sc_temperature_is_ignored(side):
    """The reference's tick samples greedily whatever the request asks
    (ROADMAP queue 3): the port keeps that."""
    eng = side.serving([side.replica(n_slots=2, max_seq=64)])
    for i, p in enumerate(_prompts(side.vocab, 2, seed=5)):
        eng.submit(side.request(i, p, max_new_tokens=5, temperature=1.5))
    eng.run_until_drained()
    return _record(eng)


MODEL_SCENARIOS = [sc_manual_greedy, sc_mixed_lengths, sc_isolated_slots,
                   sc_ws_two_replicas, sc_killed_mid_run,
                   sc_all_replicas_dead, sc_admit_race, sc_deadline,
                   sc_max_ticks, sc_heartbeat, sc_temperature_is_ignored]


# every scenario on the dense yi_6b; on an MoE, the RG-LRU hybrid and
# RWKV-6 the ones whose slots hold caches of several prompts at once,
# across ticks, replicas and a failover (the rest test the engine's
# bookkeeping, which does not depend on the model)
ARCH_SCENARIOS = [sc_manual_greedy, sc_mixed_lengths, sc_isolated_slots,
                  sc_ws_two_replicas, sc_killed_mid_run]
ENGINE_CASES = [pytest.param("yi_6b", sc, id=sc.__name__[3:])
                for sc in MODEL_SCENARIOS] + [
    pytest.param(arch, sc, id=f"{arch}-{sc.__name__[3:]}")
    for arch in ("phi35_moe", "recurrentgemma_2b", "rwkv6_3b")
    for sc in ARCH_SCENARIOS]


@pytest.mark.parametrize("arch,scenario", ENGINE_CASES)
def test_engine_equals_jax_engine(arch, scenario):
    jside, tside = arch_sides(arch)
    want = scenario(jside)
    got = scenario(tside)
    assert got == want


def test_engine_matches_manual_greedy_decode(sides):
    """The port's engine emits the greedy continuation of the port's own
    prefill + decode_step."""
    _, tside = sides
    ct = tbase.reduced(tbase.get_config("yi_6b"), dtype="float32")
    rep = tside.replica(n_slots=2, max_seq=64)
    model, params = rep.model, rep.params
    prompt = np.random.default_rng(0).integers(1, ct.vocab_size, 12).astype(
        np.int32)
    logits, cache = model.prefill(params, torch.as_tensor(prompt)[None],
                                  max_seq=64)
    toks = [int(torch.argmax(logits, -1)[0])]
    pos = len(prompt)
    for _ in range(4):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[toks[-1]]]), torch.tensor(pos))
        toks.append(int(torch.argmax(logits, -1)[0]))
        pos += 1
    eng = tside.serving([rep])
    eng.submit(tside.request(0, prompt, max_new_tokens=5))
    assert eng.run_until_drained()[0].tokens == toks


# --------------------------------------------------------------------------
# policy scenarios (tests/test_engine_policies.py), no model
# --------------------------------------------------------------------------

def fake_replica(engine_mod, n_slots=4):
    class FakeReplica:
        """Slot semantics without a model: one token per tick."""

        def __init__(self):
            self.n_slots, self.slots, self.admissions = n_slots, {}, []

        def queue_len(self):
            return len(self.slots)

        def queued_weight(self):
            return float(sum(self.slots.values()))

        def capacity(self):
            return self.n_slots

        def active_uids(self):
            return list(self.slots)

        def release(self, uid):
            self.slots.pop(uid, None)
            return []

        def admit(self, req):
            if len(self.slots) >= self.n_slots:
                raise RuntimeError("no free slot (scheduler race)")
            self.slots[req.uid] = max(int(req.max_new_tokens), 1)
            self.admissions.append(req.uid)

        def tick(self):
            done = []
            for uid in list(self.slots):
                self.slots[uid] -= 1
                if self.slots[uid] <= 0:
                    del self.slots[uid]
                    done.append(engine_mod.Completion(uid, [0]))
            return done
    return FakeReplica()


def _fake_run(side, policy, n_reps, n_slots, weights, *, evict=None,
              rounds=1, speed_fn=None):
    reg, tr = side.registry(), side.tracer()
    reps = [fake_replica(side.engine, n_slots) for _ in range(n_reps)]
    eng = side.serving(reps, policy=policy, metrics=reg, tracer=tr,
                       speed_fn=speed_fn)
    if evict is not None:
        eng._evict(evict, "test")
    for i, w in enumerate(weights):
        eng.submit(side.request(i, np.zeros(1, np.int32), max_new_tokens=w))
    for _ in range(rounds):
        eng._admit_backlog()
    first = [list(r.admissions) for r in reps]
    eng.run_until_drained(max_ticks=200)
    return dict(first=first, admissions=[r.admissions for r in reps],
                **_record(eng, metrics=reg, tracer=tr))


POLICY_CASES = {
    **{f"{p}_drains": (p, 2, 4, [4] * 6, {}) for p in
       ("drr", "od", "ws", "health_ws")},
    "od_one_per_tick": ("od", 2, 4, [4] * 8, {}),
    "od_free_slots": ("od", 1, 1, [3, 3], dict(rounds=2)),
    "drr_after_eviction": ("drr", 3, 16, [4] * 8, dict(evict=1)),
    "ws_weighted": ("ws", 3, 2, [1, 9, 2, 8, 3, 7, 4], {}),
    "health_ws_speed": ("health_ws", 2, 8, [4] * 4,
                        dict(speed_fn=lambda: {0: 0.0, 1: 1.0})),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policies_equal_jax_engine(sides, case):
    policy, n_reps, n_slots, weights, kw = POLICY_CASES[case]
    got, want = (_fake_run(s, policy, n_reps, n_slots, weights, **kw)
                 for s in reversed(sides))
    assert got == want
    assert sorted(c for c, _ in got["completed"]) == list(range(len(weights)))


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def test_sampling_temperature_zero_is_greedy():
    logits = np.array([[1.0, 5.0, 2.0], [0.0, -1.0, 3.0], [2.0, 2.0, 1.0]],
                      np.float32)
    want = np.asarray(jsampling.sample(jnp.asarray(logits),
                                       jax.random.key(0)))
    got = tsampling.sample(torch.as_tensor(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)       # first max on ties


def test_sampling_top_k_restricts_support():
    logits = torch.tensor([[10.0, 9.0, -50.0, -50.0]])
    gen = torch.Generator().manual_seed(0)
    seen = {int(tsampling.sample(logits, gen, temperature=1.0, top_k=2)[0])
            for _ in range(50)}
    assert seen == {0, 1}
    flat = torch.zeros((1, 4))
    seen = {int(tsampling.sample(flat, gen, temperature=1.0)[0])
            for _ in range(200)}
    assert seen == {0, 1, 2, 3}
