"""The port's LM training path on the CPU against the JAX package.

Each part on the same numpy inputs in both packages:

  * ``model.loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of ``repro.models.model.build_model(cfg).loss_fn``: reduced gemma3_4b
    (12 layers, two rematerialised 6-layer cycles, window 64) in f32 and in
    bf16, and an 8-layer f32 stack (one cycle and a 2-layer tail); weights
    carried by ``params_from_jax``, the JAX grad tree mapped the same way;
    sequences past the window, some labels ``IGNORE_ID``.
  * the optimizer against ``repro.train.optimizer`` (the cases of
    ``tests/test_optimizer.py`` and a multi-leaf bf16/f32 tree over steps);
  * ``make_train_step`` with ``grad_accum`` 1 and 2 against JAX's (a linear
    model, and one step of a reduced LM);
  * the loader's batches byte-equal to ``repro.data.loader``'s;
  * ``plan_mesh`` / ``rebatch_for_mesh`` equal to JAX's;
  * checkpoints: round trip, corruption skipped, shape mismatch, the async
    handle re-raising, each package's ``verify`` on the other's directory;
  * ``launch.train`` on ``device="cpu"``: the loss falls over 8 steps, and
    2 steps + checkpoint + resume equals 4 straight steps.

Tolerances (measured on these cases): loss f32 atol 1e-5 (measured 0),
gradients f32 within 2e-5 of the leaf's largest value (measured 4.3e-6:
matmul and reduction order through 12 layers); bf16 loss atol 0.01
(measured 0.0018), gradients relative L2 0.08 per leaf (measured 0.032, on
the wq and wk leaves: bf16 rounds at other places in the two frameworks'
RoPE and attention paths).  Optimizer: rtol 1e-5 / atol 1e-6 (measured
2.4e-7: multiply-adds fused in another order).  The LM train step: loss
atol 1e-5, weights as the comment there says.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import loader as jloader
from repro.models import model as jmodel
from repro.models import transformer as jtr
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import base as tbase
from repro_torch.data import loader as tloader
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tstep

B, S = 2, 96


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _configs(dtype, n_layers=None, arch="gemma3_4b"):
    over = dict(dtype=dtype)
    if n_layers:
        over["n_layers"] = n_layers
    return (jbase.reduced(jbase.get_config(arch), **over),
            tbase.reduced(tbase.get_config(arch), **over))


def _batch(vocab, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(1, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = tmodel.IGNORE_ID
    return {"tokens": tokens, "labels": labels}


def jax_grads_by_name(grads, cfg) -> dict:
    """The JAX grad tree under the port's parameter names."""
    pat = len(cfg.block_pattern)
    nc, rem = jtr.n_cycles(cfg)
    out = {"embed": grads["embed"],
           "final_norm.scale": grads["final_norm"]["scale"]}
    if "lm_head" in grads:
        out["lm_head"] = grads["lm_head"]

    def layer(i, tree):
        for part, leaves in tree.items():
            for name, g in leaves.items():
                out[f"layers.{i}.{part}.{name}"] = g
    for c in range(nc):
        for j in range(pat):
            layer(c * pat + j, jax.tree.map(lambda a, c=c: a[c],
                                            grads["scan"][j]))
    for j in range(rem):
        layer(nc * pat + j, grads["tail"][j])
    return out


LOSS_CASES = {"f32": ("float32", None), "f32_tail": ("float32", 8),
              "bf16": ("bfloat16", None)}


@pytest.fixture(scope="module", params=sorted(LOSS_CASES))
def loss_run(request):
    dtype, n_layers = LOSS_CASES[request.param]
    cj, ct = _configs(dtype, n_layers)
    pj = jtr.init(jax.random.key(0), cj)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    batch = _batch(cj.vocab_size)
    (lj, mj), gj = jax.value_and_grad(jmodel.build_model(cj).loss_fn,
                                      has_aux=True)(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt = tmodel.build_model(ct).loss_fn(pt, batch)
    names = [n for n, _ in pt.named_parameters()]
    gt = dict(zip(names, torch.autograd.grad(lt, list(pt.parameters()))))
    return dict(dtype=dtype, cj=cj, ct=ct, lj=lj, mj=mj, lt=lt, mt=mt,
                gj=jax_grads_by_name(gj, cj), gt=gt, n_layers=ct.n_layers)


def test_loss_and_metrics_equal_jax(loss_run):
    tol = 1e-5 if loss_run["dtype"] == "float32" else 0.01
    assert abs(float(loss_run["lt"].detach()) - float(loss_run["lj"])) <= tol
    assert float(loss_run["mt"]["n_tokens"]) == float(
        loss_run["mj"]["n_tokens"]) == B * S - 5
    assert set(loss_run["mt"]) == set(loss_run["mj"]) == {"loss",
                                                          "n_tokens"}


def test_every_gradient_leaf_equals_jax(loss_run):
    gj, gt = loss_run["gj"], loss_run["gt"]
    assert set(gj) == set(gt)
    assert len(gt) == 3 + 9 * loss_run["n_layers"]
    for name, g in gt.items():
        want, got = _np(gj[name]), _np(g)
        assert got.shape == want.shape, name
        assert g.dtype == tbase_dtype(loss_run["dtype"]), name
        if loss_run["dtype"] == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-5 * np.abs(want).max(),
                                       err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= 0.08, (name, rel)


def tbase_dtype(name):
    return getattr(torch, name)


def test_remat_changes_no_gradient():
    """Per-cycle rematerialisation recomputes, it does not change."""
    _, ct = _configs("float32", 8)
    model = tmodel.build_model(ct)
    pt = model.init(torch.Generator("cpu").manual_seed(0))
    batch = _batch(ct.vocab_size)
    grads = []
    for remat in (True, False):
        loss, _ = model.loss_fn(pt, batch, remat=remat)
        grads.append(torch.autograd.grad(loss, list(pt.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_chunked_cross_entropy_equals_whole_logits():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (2, 64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (16, 40)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 40, (2, 64)))
    labels[1, 3:9] = tmodel.IGNORE_ID
    loss, n = tmodel.chunked_cross_entropy(x, lambda h: h @ w, labels,
                                           chunk=16)
    want = torch.nn.functional.cross_entropy(
        (x @ w).reshape(-1, 40), labels.reshape(-1),
        ignore_index=tmodel.IGNORE_ID)
    assert float(n) == 2 * 64 - 6
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        tmodel.chunked_cross_entropy(x[:, :60], lambda h: h @ w,
                                     labels[:, :60], chunk=16)


# --------------------------------------------------------------------------
# optimizer and train step
# --------------------------------------------------------------------------

OPT_CASES = {
    # tests/test_optimizer.py
    "first_step": (dict(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                        clip_norm=1e9, warmup_steps=0, total_steps=1,
                        min_lr_ratio=1.0),
                   {"w": [1.0, -2.0]}, {"w": [0.5, 0.5]}, "float32"),
    "weight_decay": (dict(lr=0.1, weight_decay=0.5, warmup_steps=0,
                          total_steps=1, min_lr_ratio=1.0, clip_norm=1e9),
                     {"w": [4.0]}, {"w": [0.0]}, "float32"),
    "clip": (dict(lr=1.0, clip_norm=1.0, weight_decay=0.0, warmup_steps=0,
                  total_steps=1, min_lr_ratio=1.0),
             {"w": [0.0, 0.0]}, {"w": [3.0, 4.0]}, "float32"),
    "bf16_master": (dict(lr=1e-3, warmup_steps=0, total_steps=1,
                         min_lr_ratio=1.0, weight_decay=0.0),
                    {"w": [1.0] * 4}, {"w": [1e-3] * 4}, "bfloat16"),
}


def _opt_both(cfg_kw, p, g, dtype, steps=1):
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    pj = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    mj, vj = jopt.init_moments(pj)
    pt = {k: torch.tensor(v, dtype=getattr(torch, dtype))
          for k, v in p.items()}
    mt, vt = topt.init_moments(pt)
    for step in range(steps):
        gj = {k: jnp.asarray(np.asarray(v) * (step + 1), dtype)
              for k, v in g.items()}
        gt = {k: torch.tensor(np.asarray(v) * (step + 1),
                              dtype=getattr(torch, dtype))
              for k, v in g.items()}
        pj, mj, vj, sj = jopt.adamw_update(gj, mj, vj, pj, jnp.int32(step),
                                           jcfg)
        st = topt.adamw_update(gt, mt, vt, pt, step, tcfg)
        assert float(st["grad_norm"]) == pytest.approx(float(sj["grad_norm"]),
                                                       rel=1e-6)
        assert st["lr"] == float(sj["lr"])
    return (pj, mj, vj), (pt, mt, vt)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_matches_jax(case):
    cfg_kw, p, g, dtype = OPT_CASES[case]
    (pj, mj, vj), (pt, mt, vt) = _opt_both(cfg_kw, p, g, dtype, steps=3)
    for k in p:
        assert pt[k].dtype == getattr(torch, dtype)
        assert mt[k].dtype == vt[k].dtype == torch.float32
        for a, b in ((pt, pj), (mt, mj), (vt, vj)):
            np.testing.assert_allclose(_np(a[k]), _np(b[k]), rtol=1e-5,
                                       atol=1e-6)


def test_adamw_multi_leaf_tree_over_steps():
    rng = np.random.default_rng(4)
    p = {"a": rng.normal(0, 1, (5, 3)).tolist(),
         "b": rng.normal(0, 1, (7,)).tolist()}
    g = {"a": rng.normal(0, 2, (5, 3)).tolist(),
         "b": rng.normal(0, 2, (7,)).tolist()}
    cfg_kw = dict(lr=0.05, warmup_steps=2, total_steps=6, clip_norm=1.0)
    for dtype in ("float32", "bfloat16"):
        (pj, mj, vj), (pt, mt, vt) = _opt_both(cfg_kw, p, g, dtype, steps=5)
        for k in p:
            np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 60, 109, 110, 200])
def test_lr_schedule_matches_jax(step):
    cfg_kw = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    want = float(jopt.lr_at(jopt.AdamWConfig(**cfg_kw), jnp.int32(step)))
    got = topt.lr_at(topt.AdamWConfig(**cfg_kw), step)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def _linear_loss_jax(params, batch):
    pred = batch["x"] @ params["w"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"loss": loss}


def _linear_loss_torch(params, batch):
    pred = batch["x"] @ params["w"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"loss": loss}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_linear_matches_jax(grad_accum):
    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 1, (4, 3)).astype(np.float32)
    x = rng.normal(0, 1, (8, 4)).astype(np.float32)
    y = rng.normal(0, 1, (8, 3)).astype(np.float32)
    cfg_kw = dict(lr=1e-2, warmup_steps=0, total_steps=2, min_lr_ratio=1.0)
    sj = jstep.init_state({"w": jnp.asarray(w0)})
    fj = jstep.make_train_step(_linear_loss_jax, jopt.AdamWConfig(**cfg_kw),
                               grad_accum=grad_accum)
    st = tstep.init_state({"w": torch.from_numpy(w0.copy())})
    ft = tstep.make_train_step(_linear_loss_torch,
                               topt.AdamWConfig(**cfg_kw),
                               grad_accum=grad_accum)
    for _ in range(2):
        sj, mj = fj(sj, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        st, mt = ft(st, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]),
                                                  rel=1e-5)
    assert st.step == int(sj.step) == 2
    np.testing.assert_allclose(_np(st.params["w"]), _np(sj.params["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(st.v["w"]), _np(sj.v["w"]), rtol=1e-5,
                               atol=1e-9)


def test_lm_train_step_with_grad_accum_matches_jax():
    """One step of reduced gemma3_4b (one 6-layer cycle, f32), batch 4 in
    two microbatches: every parameter and moment after the step."""
    cj, ct = _configs("float32", 6)
    pj = jtr.init(jax.random.key(1), cj)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    batch = _batch(cj.vocab_size, b=4, s=32, seed=2)
    cfg_kw = dict(lr=1e-3, warmup_steps=0, total_steps=4)
    fj = jax.jit(jstep.make_train_step(
        lambda p, b: jmodel.build_model(cj).loss_fn(p, b),
        jopt.AdamWConfig(**cfg_kw), grad_accum=2))
    sj, mj = fj(jstep.init_state(pj),
                {k: jnp.asarray(v) for k, v in batch.items()})
    st, mt = tstep.make_train_step(tmodel.build_model(ct).loss_fn,
                                   topt.AdamWConfig(**cfg_kw),
                                   grad_accum=2)(tstep.init_state(pt), batch)
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), abs=1e-5)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=1e-4)
    want = jax_grads_by_name(sj.params, cj)
    want_m = jax_grads_by_name(sj.m, cj)
    lr = cfg_kw["lr"]
    for name, p in st.params.named_parameters():
        # Adam's first step moves a weight by lr * g / (|g| + eps): where g
        # is near 0 (within f32 noise of the two packages' sums) that
        # fraction of lr differs, on a few elements in 10,000
        diff = np.abs(_np(p) - _np(want[name]))
        assert diff.max() <= 0.1 * lr, name
        assert (diff > 1e-5).mean() <= 1e-3, name
        np.testing.assert_allclose(_np(st.m[name]), _np(want_m[name]),
                                   rtol=0, atol=2e-5 * max(
                                       np.abs(_np(want_m[name])).max(), 1),
                                   err_msg=name)


# --------------------------------------------------------------------------
# loader and mesh planning
# --------------------------------------------------------------------------

def test_loader_batches_are_byte_equal_to_jax():
    kw = dict(global_batch=8, seq_len=130, vocab_size=1000, seed=3,
              mean_doc_len=32)
    for host in range(4):
        lj = jloader.ShardedLoader(jloader.LoaderConfig(**kw),
                                   host_index=host, num_hosts=4)
        lt = tloader.ShardedLoader(tloader.LoaderConfig(**kw),
                                   host_index=host, num_hosts=4)
        for seek in (None, 7, 2):
            if seek is not None:
                lj.seek(seek)
                lt.seek(seek)
            for _ in range(3):
                a, b = lj.next_batch(), lt.next_batch()
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype == np.int32
                    assert a[k].tobytes() == b[k].tobytes()
        assert lt.state_dict() == lj.state_dict()
    with pytest.raises(ValueError, match="divide"):
        tloader.ShardedLoader(tloader.LoaderConfig(**kw), num_hosts=3)


def test_loader_prefetch_on_the_cpu_yields_the_same_batches():
    cfg = tloader.LoaderConfig(global_batch=2, seq_len=16, vocab_size=50)
    want = tloader.ShardedLoader(cfg)
    it = tloader.ShardedLoader(cfg).prefetched("cpu")
    for _ in range(3):
        got, exp = next(it), want.next_batch()
        for k in exp:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), exp[k])


@pytest.mark.parametrize("chips", [16, 17, 100, 256, 511, 512, 1000, 2048])
def test_plan_mesh_and_rebatch_match_jax(chips):
    want = jelastic.plan_mesh(chips)
    got = telastic.plan_mesh(chips)
    assert got == want
    for gb in (1, 7, 64, 1000):
        assert telastic.rebatch_for_mesh(gb, *got) == \
            jelastic.rebatch_for_mesh(gb, *want)
    assert telastic.TP_ANCHOR == jelastic.TP_ANCHOR
    with pytest.raises(ValueError):
        telastic.plan_mesh(8)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _state():
    return {"params": {"scan": ({"w": torch.arange(6.0).reshape(2, 3)},),
                       "embed": torch.ones((4, 2), dtype=torch.bfloat16)
                       * 1.5},
            "step": np.int32(7)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zeros_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.int32(0)


def test_checkpoint_roundtrip(tmp_path):
    s = _state()
    path = tckpt.save(str(tmp_path), 7, s)
    r = tckpt.restore(path, _zeros_like(s))
    assert torch.equal(r["params"]["scan"][0]["w"], s["params"]["scan"][0]["w"])
    assert r["params"]["embed"].dtype == torch.bfloat16
    assert torch.equal(r["params"]["embed"], s["params"]["embed"])
    assert r["step"] == 7 and tckpt.manifest_step(path) == 7
    assert path.endswith("step_0000000007") and tckpt.verify(path)


def test_checkpoint_latest_valid_skips_corruption(tmp_path):
    s = _state()
    tckpt.save(str(tmp_path), 1, s)
    tckpt.save(str(tmp_path), 10, s)
    p5 = tckpt.save(str(tmp_path), 5, s)
    assert tckpt.latest_valid(str(tmp_path)).endswith("step_0000000010")
    p12 = tckpt.save(str(tmp_path), 12, s)
    victim = [f for f in os.listdir(p12) if f.endswith(".npy")][0]
    with open(os.path.join(p12, victim), "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xff\xff\xff\xff")
    assert not tckpt.verify(p12) and tckpt.verify(p5)
    assert tckpt.latest_valid(str(tmp_path)).endswith("step_0000000010")


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = tckpt.save(str(tmp_path), 1, _state())
    bad = _zeros_like(_state())
    bad["params"]["embed"] = torch.zeros((9, 9), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(path, bad)


def test_async_save_handle_reraises_writer_errors(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("disk full")
    monkeypatch.setattr(tckpt.np, "save", boom)
    handle = tckpt.save(str(tmp_path), 1, _state(), blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        handle.wait(timeout=30)
    assert handle.done
    assert tckpt.latest_valid(str(tmp_path)) is None


def test_async_save_lands_and_is_pathlike(tmp_path):
    handle = tckpt.save(str(tmp_path), 4, _state(), blocking=False)
    assert handle.wait(timeout=30).endswith("step_0000000004")
    assert os.path.isdir(handle) and handle.done and tckpt.verify(handle)


def test_each_package_verifies_the_others_checkpoints(tmp_path):
    jstate = {"params": {"scan": ({"w": jnp.arange(6.0).reshape(2, 3)},),
                         "embed": jnp.ones((4, 2), jnp.bfloat16) * 1.5},
              "step": jnp.int32(7)}
    pj = jckpt.save(str(tmp_path / "jax"), 7, jstate)
    pt = tckpt.save(str(tmp_path / "torch"), 7, _state())
    assert jckpt.verify(pt) and tckpt.verify(pj)
    assert jckpt.verify(pj) and tckpt.verify(pt)
    # the same bytes under both: bf16 leaves as raw bytes, same crc32
    import json
    mj = json.load(open(os.path.join(pj, "manifest.json")))["leaves"]
    mt = json.load(open(os.path.join(pt, "manifest.json")))["leaves"]
    assert sorted(m["crc32"] for m in mj.values()) == sorted(
        m["crc32"] for m in mt.values())
    assert sorted(m["dtype"] for m in mj.values()) == sorted(
        m["dtype"] for m in mt.values())
    assert jckpt.latest_valid(str(tmp_path / "torch")) == pt


def test_train_state_checkpoint_keys_are_state_paths(tmp_path):
    _, ct = _configs("float32", 6)
    pt = tmodel.build_model(ct).init(torch.Generator("cpu").manual_seed(0))
    state = tstep.init_state(pt)
    state.step = 3
    path = tckpt.save(str(tmp_path), 3, state)
    import json
    keys = json.load(open(os.path.join(path, "manifest.json")))["leaves"]
    assert "params/layers/0/attn/wq" in keys and "m/embed" in keys
    assert "v/layers/5/mlp/w_down" in keys and "step" in keys
    fresh = tstep.init_state(tmodel.build_model(ct).init(
        torch.Generator("cpu").manual_seed(1)))
    back = tckpt.restore(path, fresh)
    assert back.step == 3 and back.params is fresh.params
    for (n, a), (_, b) in zip(pt.named_parameters(),
                              back.params.named_parameters()):
        assert torch.equal(a, b), n


# --------------------------------------------------------------------------
# the launcher on the CPU
# --------------------------------------------------------------------------

def test_train_on_the_cpu_learns_and_checkpoints(tmp_path):
    from repro_torch.launch.train import train
    out = train("gemma3_4b", reduced=True, steps=8, global_batch=2,
                seq_len=64, ckpt_dir=str(tmp_path), ckpt_every=4,
                log_every=100, device="cpu")
    assert all(np.isfinite(out["history"]))
    assert out["last_loss"] < out["first_loss"]
    assert len(out["seconds"]) == 8 and out["state"].step == 8
    assert tckpt.latest_valid(str(tmp_path)).endswith("step_0000000008")


def test_train_resume_equals_a_straight_run(tmp_path):
    """4 steps straight == 2 steps, a checkpoint, a resume for 2 more
    (tests/test_checkpoint.py for the JAX driver; here bit for bit)."""
    from repro_torch.launch.train import train
    kw = dict(reduced=True, global_batch=2, seq_len=32, log_every=100,
              device="cpu")
    straight = train("gemma3_4b", steps=4, **kw)
    ck = str(tmp_path / "ck")
    train("gemma3_4b", steps=2, ckpt_dir=ck, ckpt_every=2, **kw)
    resumed = train("gemma3_4b", steps=4, ckpt_dir=ck, ckpt_every=10, **kw)
    assert resumed["history"] == straight["history"][2:]
    for (n, a), (_, b) in zip(straight["state"].params.named_parameters(),
                              resumed["state"].params.named_parameters()):
        assert torch.equal(a, b), n


def test_launcher_refuses_unported_arch_and_missing_card():
    from repro_torch.launch.train import train
    with pytest.raises(ValueError, match="not ported"):
        train("rwkv6_3b", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train("gemma3_4b", steps=1)


def test_phi4_mini_config_is_the_jax_one():
    for arch in ("gemma3_4b", "phi4_mini"):
        assert dataclasses.asdict(tbase.get_config(arch)) == \
            dataclasses.asdict(jbase.get_config(arch))
    assert tbase.get_config("gemma3_4b").param_count() == 4_550_993_920
