"""The loss path of the port's other LM architectures on the CPU against
the JAX package.

``model.loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
``repro.models.model.build_model(cfg).loss_fn``, on reduced configs of
musicgen_medium, llava_next_34b (its 8 frontend embeddings in the batch,
their positions masked out of the labels), phi35_moe and llama4_scout (the
loss adds 0.01 of the MoE aux; the metrics carry ``moe_aux`` and
``moe_dropped``), recurrentgemma_2b and rwkv6_3b (two 128-token chunks), in
f32, and phi35_moe and recurrentgemma_2b in bf16; weights carried by
``params_from_jax``, every cycle rematerialised as in the JAX package,
some labels ``IGNORE_ID``.  Then remat changes no MoE gradient, and
``launch.train`` feeds the frontend's embeddings.

Tolerances (measured on these cases): f32 loss and metrics atol 1e-5
(measured 4.8e-7), every gradient leaf within 2e-5 of its largest value
(measured 7.9e-6: matmul and reduction order); bf16 loss and metrics atol
0.01 (measured 1.6e-3), gradients relative L2 0.08 a leaf (the dense
stacks' bound in ``tests/test_torch_train.py``; measured 0.062 on
phi35_moe, 0.029 on recurrentgemma_2b: bf16 rounds at other places in the
two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import frontends as jfront
from repro.models import model as jmodel
from repro.models import transformer as jtr
from repro_torch.configs import base as tbase
from repro_torch.models import frontends as tfront
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr

B = 2
CASES = {f"{a}_f32": (a, "float32") for a in (
    "musicgen_medium", "llava_next_34b", "phi35_moe", "llama4_scout",
    "recurrentgemma_2b", "rwkv6_3b")}
CASES.update(phi35_moe_bf16=("phi35_moe", "bfloat16"),
             recurrentgemma_2b_bf16=("recurrentgemma_2b", "bfloat16"))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _configs(arch, dtype):
    return (jbase.reduced(jbase.get_config(arch), dtype=dtype),
            tbase.reduced(tbase.get_config(arch), dtype=dtype))


def _batches(cj, ct, s):
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cj.vocab_size, (B, s)).astype(np.int32)
    labels = rng.integers(1, cj.vocab_size, (B, s)).astype(np.int32)
    labels[0, -5:] = tmodel.IGNORE_ID
    bj = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    bt = {"tokens": tokens, "labels": labels}
    fe = jfront.fake_frontend_embeds(cj, B)
    if fe is not None:
        bj["frontend_embeds"] = fe
        bt["frontend_embeds"] = tfront.fake_frontend_embeds(ct, B,
                                                            device="cpu")
    return bj, bt


def _leaves(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def jax_grads_by_name(grads, cfg) -> dict:
    """The JAX grad tree under the port's parameter names (nested
    sub-trees, such as the MoE's shared expert, joined by dots)."""
    pat = len(cfg.block_pattern)
    nc, rem = jtr.n_cycles(cfg)
    out = dict(_leaves({k: v for k, v in grads.items()
                        if k not in ("scan", "tail")}, ""))
    for c in range(nc):
        for j in range(pat):
            out.update(_leaves(jax.tree.map(lambda a, c=c: a[c],
                                            grads["scan"][j]),
                               f"layers.{c * pat + j}."))
    for j in range(rem):
        out.update(_leaves(grads["tail"][j], f"layers.{nc * pat + j}."))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def loss_run(request):
    arch, dtype = CASES[request.param]
    cj, ct = _configs(arch, dtype)
    s = 256 if arch == "rwkv6_3b" else 96
    pj = jtr.init(jax.random.key(0), cj)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    bj, bt = _batches(cj, ct, s)
    (lj, mj), gj = jax.value_and_grad(jmodel.build_model(cj).loss_fn,
                                      has_aux=True)(pj, bj)
    lt, mt = tmodel.build_model(ct).loss_fn(pt, bt)
    names = [n for n, _ in pt.named_parameters()]
    gt = dict(zip(names, torch.autograd.grad(lt, list(pt.parameters()))))
    return dict(dtype=dtype, ct=ct, s=s, lj=lj, mj=mj, lt=lt, mt=mt,
                gj=jax_grads_by_name(gj, cj), gt=gt)


def test_loss_and_metrics_equal_jax(loss_run):
    tol = 1e-5 if loss_run["dtype"] == "float32" else 0.01
    ct = loss_run["ct"]
    mj, mt = loss_run["mj"], loss_run["mt"]
    assert abs(float(loss_run["lt"].detach()) - float(loss_run["lj"])) <= tol
    want_keys = {"loss", "n_tokens"} | (
        {"moe_aux", "moe_dropped"} if ct.is_moe else set())
    assert set(mt) == set(mj) == want_keys
    for k in want_keys:
        assert abs(float(mt[k]) - float(mj[k])) <= tol, k
    masked = B * ct.frontend_tokens + 5
    assert float(mt["n_tokens"]) == B * loss_run["s"] - masked
    if ct.is_moe:                       # the loss holds 0.01 of the aux
        assert float(loss_run["lt"]) == pytest.approx(
            float(mt["loss"]) + 0.01 * float(mt["moe_aux"]), abs=1e-6)


def test_every_gradient_leaf_equals_jax(loss_run):
    gj, gt = loss_run["gj"], loss_run["gt"]
    assert set(gj) == set(gt)
    for name, g in gt.items():
        want, got = _np(gj[name]), _np(g)
        assert got.shape == want.shape, name
        assert str(g.dtype)[6:] == str(gj[name].dtype), name
        if loss_run["dtype"] == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-5 * np.abs(want).max(),
                                       err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= 0.08, (name, rel)


def test_moe_remat_changes_no_gradient():
    """The MoE aux comes out of each rematerialised cycle; recomputing the
    routing in the backward changes no gradient and no metric."""
    _, ct = _configs("phi35_moe", "float32")
    model = tmodel.build_model(ct)
    pt = model.init(torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(0)
    bt = {k: rng.integers(1, ct.vocab_size, (B, 64)) for k in ("tokens",
                                                               "labels")}
    out = []
    for remat in (True, False):
        loss, metrics = model.loss_fn(pt, bt, remat=remat)
        out.append((metrics, torch.autograd.grad(loss,
                                                 list(pt.parameters()))))
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llava_next_34b", "phi35_moe"])
def test_train_on_the_cpu_runs_the_new_architectures(arch):
    """``launch.train`` puts the frontend's embeddings into every batch
    (llava_next_34b) and trains through the MoE aux (phi35_moe)."""
    from repro_torch.launch.train import train
    out = train(arch, reduced=True, steps=6, global_batch=2, seq_len=32,
                log_every=100, device="cpu")
    assert all(np.isfinite(out["history"]))
    assert out["last_loss"] < out["first_loss"]
