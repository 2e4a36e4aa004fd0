"""The port's partitioned step: DTensors over a device mesh.

Every run that makes a process group is a subprocess of its own
(``tests/_torch_mesh.py``), with its own timeout:

  * (i) tests/test_dryrun_small.py's five cells, at its reduced configs and
    shrunk shapes, counted on a fake (2, 4) mesh: each communicates, the
    JAX test's own assertion; and each against the JAX dry run's count of
    the same cell on its faked 8-device mesh: the collective ops by name,
    and the port-to-JAX ratios of per-device flops and of collective
    bytes (in all, all-gathers, reductions) within 1.25x of their
    measured values (``JAX_RATIO``);
  * (ii) the per-device counter: a replicated op at its full size on each
    device, a sharded matmul at 1/N, and a second run counting what the
    first did (DTensor caches its sharding propagation);
  * (iii) a real 4-rank ``gloo`` run on a (2, 2) mesh of reduced yi_6b,
    phi35_moe and rwkv6_3b train steps (f32; rwkv6's chunk loop runs on
    each rank's rows), at 8 rows, and of yi_6b and phi35_moe at 64 rows
    in 4 microbatches (rows whose label counts differ, so that each
    microbatch must hold the batch's consecutive rows): the loss and every
    gathered gradient leaf of the step against the one-process port step
    and ``jax.value_and_grad`` over the same microbatches on the same
    weights (``params_from_jax``), and the collective bytes rank 0
    counted against the fake-mesh meta count of the same step, exactly;
  * serving on the same mesh: a prefill (the cache laid out by its
    specs, sequence-parallel on the global layers) and a decode step of
    reduced gemma2_9b, recurrentgemma_2b and rwkv6_3b (f32) against the
    one-process port: logits and every cache entry;
  * (iv) the tree path: two frontier supersteps on a (2, 2) gloo mesh (the
    cases sharded, the plain kernels on the CPU shards; with and without
    compaction, under the default layout knobs and without ``yadt_rs`` and
    ``yadt_compact``) against the JAX frontier's histogram, scores and
    split; and four, by when some cases lie in closed nodes and the
    compaction pads each rank's live cases to the largest rank's count,
    against the one-process port.

In this process: the ring factors of ``collective_bytes`` against the JAX
function's on the same collectives, and the layout helpers' shapes.

Tolerances (measured here, f32): the partitioned loss equals the
one-process port's within 1e-6 relative (measured 0 for yi_6b, 7.1e-8 for
phi35_moe; 0 for both at 64 rows); gradients within 1e-5 of each leaf's
largest value against the port (measured 1.4e-6, 1.5e-6 at 64 rows: the
shards' matmuls and reductions add in another order) and against JAX
(measured 2.4e-6, 2.5e-6 at 64 rows, as tests/test_torch_train.py's
2e-5); rwkv6_3b's within 5e-4 (measured 1.3e-4 against the port, 3.7e-5
against JAX; the one-process port stands 1.7e-4 from JAX on this batch),
its grad norm rel 1e-3 (measured 1.2e-4); the moments after the step,
1e-5 absolute (they hold g and g^2).
Serving: logits and cache entries within 1e-5 of each one's largest
value (measured 1.7e-6).  The tree path equals the one-process port's
bit for bit, and JAX's histogram (integral weights) and split exactly;
its f32 scores within rtol 1e-5 / atol 1e-6 of JAX's (measured 5.9e-7:
the port's scorer adds in another order, as
tests/test_torch_kernels_ref.py's split-gain cases).
"""

import functools
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_mesh
from _torch_mesh import CELLS

# gradients within this share of each leaf's largest value; rwkv6_3b's
# chunked recurrence (its bonus u's gradient reaches 68 on this batch)
# carries the reduction order further
GRAD_RTOL = {"yi_6b": 1e-5, "phi35_moe": 1e-5, "rwkv6_3b": 5e-4}
SERVE_RTOL = 1e-5


# The JAX dry run's count of the same five cells on its faked 8-device
# mesh (repro.launch.dryrun.run_cell's analysis: each analysis cell
# lowered unrolled and read by repro.launch.roofline.analyze).
JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import sys

    from repro.configs import base as cfgbase
    from repro.launch import roofline as rl
    from repro.launch.mesh import make_mesh_compat
    from repro.launch.specs import lower_cell, make_analysis_cells

    mesh = make_mesh_compat((2, 4), ("data", "model"))
    cfgbase.SHAPES = {
        "train_4k": cfgbase.ShapeSpec("train_4k", 128, 8, "train"),
        "prefill_32k": cfgbase.ShapeSpec("prefill_32k", 256, 4, "prefill"),
        "decode_32k": cfgbase.ShapeSpec("decode_32k", 256, 8, "decode"),
        "long_500k": cfgbase.ShapeSpec("long_500k", 512, 1, "decode"),
    }
    reduced = {a: cfgbase.reduced(cfgbase.get_config(a))
               for a in cfgbase.ARCH_IDS if a != "yadt"}
    cfgbase.get_config = lambda a: reduced[a]
    out = {}
    for arch, shape in json.loads(sys.argv[1]):
        flops, by_op = 0.0, {}
        for cell, scale in make_analysis_cells(arch, shape, mesh):
            r = rl.analyze(lower_cell(cell, mesh, unroll=True).compile(),
                           arch=arch, shape=shape, mesh_desc="2x4",
                           n_devices=8)
            flops += scale * r.device_flops
            for k, v in r.coll_by_op.items():
                by_op[k] = by_op.get(k, 0.0) + scale * v
        out[f"{arch}/{shape}"] = dict(flops=flops, by_op=by_op)
    print("RESULT" + json.dumps(out))
""")

# The port's count over the JAX count of each cell, measured here (torch
# 2.13 and jax on the CPU): per-device flops, all collective bytes, the
# all-gathers, and the reductions (all-reduce and reduce-scatter: XLA's
# CPU lowering reduces the ZeRO-3 gradients with all-reduces, the port
# reduce-scatters them).  The flop counters differ: XLA counts every
# elementwise op, FlopCounterMode the matmul-like ones and the kernels'
# formulas (rwkv6's decode is mostly elementwise).  The layouts differ
# where GSPMD and DTensor choose differently: recurrentgemma's MLP output
# pinned over TP is a reduce-scatter of partial sums on DTensor, GSPMD
# gathers the weights; rwkv6's batch-1 pins gather each TP-split
# activation (5e4 B in all).  A cell may move within RATIO_BAND of its
# measured ratio either way (torch 2.11 and 2.13 count yi_6b's train
# collectives 6% apart).
JAX_RATIO = {
    "yi_6b/train_4k": dict(flops=0.7383, coll=1.0940, ag=0.7271,
                           red=1.8337),
    "phi35_moe/train_4k": dict(flops=0.8951, coll=1.2392, ag=1.6712,
                               red=0.6846),
    "gemma2_9b/decode_32k": dict(flops=0.6849, coll=0.7394, ag=0.6927,
                                 red=0.3243),
    "rwkv6_3b/long_500k": dict(flops=0.3478, coll=6.0846, ag=5.1987,
                               red=1.8479),
    "recurrentgemma_2b/prefill_32k": dict(flops=1.0058, coll=1.7817,
                                          ag=0.8598, red=17.2009),
}
RATIO_BAND = 1.25
JAX_OPS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
           "collective-permute"}


@functools.cache
def _port_cell(arch, shape):
    """The port's dry run of a small cell on a fake (2, 4) mesh and on
    one device."""
    return _torch_mesh.run("cell", arch, shape, "2x4", timeout=300)


@pytest.fixture(scope="module")
def jax_small_counts():
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(CELLS)],
        capture_output=True, text=True, timeout=600, cwd=_torch_mesh.ROOT,
        env={"PYTHONPATH": str(_torch_mesh.ROOT / "src"),
             "PATH": "/usr/bin:/bin", "HOME": str(_torch_mesh.ROOT),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_small_mesh_cells_communicate(arch, shape):
    res = _port_cell(arch, shape)
    r, one = res["mesh"], res["one"]
    assert r["status"] == "ok" and r["split"] == "partitioned"
    assert r["device_flops"] > 0
    assert r["device_coll_bytes"] > 0, "sharded step must communicate"
    assert r["coll_link"] == "nvlink4"
    assert r["device_flops"] <= one["device_flops"]
    assert r["mem_args_gb"] < one["mem_args_gb"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_small_mesh_cells_against_the_jax_dry_run(arch, shape,
                                                  jax_small_counts):
    key = f"{arch}/{shape}"
    r, j = _port_cell(arch, shape)["mesh"], jax_small_counts[key]
    port_by, jax_by = r["coll_by_op"], j["by_op"]
    assert set(port_by) <= JAX_OPS
    assert {"all-gather", "all-reduce"} <= set(port_by) & set(jax_by)
    if shape == "train_4k":
        # ZeRO-3: the gradients reduce-scattered onto their shards
        assert "reduce-scatter" in port_by

    def red(by):
        return by.get("all-reduce", 0.0) + by.get("reduce-scatter", 0.0)
    got = dict(flops=r["device_flops"] / j["flops"],
               coll=sum(port_by.values()) / sum(jax_by.values()),
               ag=port_by["all-gather"] / jax_by["all-gather"],
               red=red(port_by) / red(jax_by))
    for name, want in JAX_RATIO[key].items():
        assert want / RATIO_BAND <= got[name] <= want * RATIO_BAND, (
            key, name, got[name], want)


@pytest.mark.timeout(120)
def test_counter_counts_one_devices_ops():
    res = _torch_mesh.run("counter", timeout=120)
    # each step counted twice counts the same (the propagator's cached
    # global-shape runs are left out of both)
    for name in ("replicated", "matmul", "gather"):
        assert res[name][0] == res[name][1], name
    rep, mm, gather = (res[n][0] for n in ("replicated", "matmul", "gather"))
    # a replicated op: its full size on each device, as on one
    assert rep["bytes"] == res["replicated_one"]["bytes"] == 2 * 64 * 32 * 4
    assert rep["coll"] == 0
    # the (8, 64) @ (64, 32) product: (4, 64) @ (64, 8) on each of 8
    assert mm["flops"] == res["matmul_one"]["flops"] / 8 == 2 * 4 * 64 * 8
    assert mm["bytes"] == (4 * 64 + 64 * 8 + 4 * 8) * 4 and mm["coll"] == 0
    # gathered: (4, 8) f32 over model (4 ranks), then (4, 32) over data
    # (2), each result by the ring factor (g - 1) / g
    assert gather["flops"] == mm["flops"] and gather["n"] == 2
    assert gather["by_op"] == {"all-gather": 4 * 32 * 4 * 3 / 4
                               + 8 * 32 * 4 / 2}


@pytest.mark.parametrize("op,factor", [
    ("all-gather", 3 / 4), ("all-reduce", 2 * 3 / 4),
    ("reduce-scatter", 3.0), ("all-to-all", 3 / 4),
    ("collective-permute", 1.0)])
def test_collective_bytes_is_the_jax_ring_model(op, factor):
    from repro.launch import roofline as jrl
    from repro_torch.launch import roofline as rl
    hlo = (f"  %x = f32[16,32] {op}(f32[16,32] %y), "
           f"replica_groups=[2,4]<=[8]")
    jax_total, jax_by = jrl.collective_bytes(hlo, n_devices=8)
    total, by = rl.collective_bytes([(op, 16 * 32 * 4, 4)])
    assert total == jax_total == 16 * 32 * 4 * factor and by == jax_by
    assert rl.collective_bytes([(op, 64, 1)]) == (0.0, {})


@pytest.mark.timeout(120)
def test_distribute_gives_shard_shape_and_gathers_back():
    res = _torch_mesh.run("layout", timeout=120)
    for name, r in res["shapes"].items():
        assert r["local"] == r["shard_shape"], name
    assert res["gathered_equal"] and res["group_gone"]


def _train_inputs(arch, tmp_path, rows=8):
    import jax

    from repro.configs import base as jbase
    from repro.models import model as jmodel
    from repro.models import transformer as jtr
    from repro_torch.configs import base as tbase
    from repro_torch.models import transformer as ttr
    cj = jbase.reduced(jbase.get_config(arch), dtype="float32")
    ct = tbase.reduced(tbase.get_config(arch), dtype="float32")
    pj = jtr.init(jax.random.key(0), cj)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    rng = np.random.default_rng(0)
    # the small train_4k shape: 8 rows of 128 tokens, or 64 rows in 4
    # microbatches
    batch = {k: rng.integers(1, cj.vocab_size, (rows, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    if rows > 8:
        # row r ignores its last 9 * (r % 11) labels: each microbatch's
        # loss is normalised by its own rows' count, so a microbatch of
        # other rows gives another loss
        for r in range(rows):
            batch["labels"][r, 128 - 9 * (r % 11):] = jmodel.IGNORE_ID
    path = tmp_path / "in.npz"
    np.savez(path, **{f"p:{n}": p.detach().numpy()
                      for n, p in pt.named_parameters()},
             **{f"b:{k}": v for k, v in batch.items()})
    return cj, pj, batch, path


@pytest.fixture(scope="module", params=[
    ("yi_6b", 8), ("phi35_moe", 8), ("rwkv6_3b", 8), ("yi_6b", 64),
    ("phi35_moe", 64)],
    ids=lambda p: p[0] if p[1] == 8 else f"{p[0]}-b{p[1]}")
def gloo_train(request, tmp_path_factory):
    """The gloo train step of an arch at 8 rows (one microbatch) or at 64
    (4 microbatches of 16 consecutive rows, the JAX step's split), with
    JAX's loss and gradients over the same microbatches."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as jmodel
    from test_torch_train import jax_grads_by_name
    arch, rows = request.param
    tmp = tmp_path_factory.mktemp(f"{arch}-{rows}")
    cj, pj, batch, path = _train_inputs(arch, tmp, rows)
    res = _torch_mesh.run("gloo_train", arch, str(path), str(tmp),
                          rows if rows > 8 else None, timeout=600)
    n = 4 if rows >= 64 else 1
    grad_fn = jax.jit(jax.value_and_grad(jmodel.build_model(cj).loss_fn,
                                         has_aux=True))
    lj, gj = 0.0, None
    for i in range(n):
        mb = {k: jnp.asarray(v[i * rows // n:(i + 1) * rows // n])
              for k, v in batch.items()}
        (loss, metrics), g = grad_fn(pj, mb)
        # what the JAX step's compute_grads returns: the loss, or over
        # microbatches the mean of its metric (without the MoE aux term)
        lj += float(loss if n == 1 else metrics["loss"]) / n
        g = {k: np.asarray(v, np.float64) / n
             for k, v in jax_grads_by_name(g, cj).items()}
        gj = g if gj is None else {k: gj[k] + g[k] for k in g}
    out = dict(np.load(tmp / "gloo.npz"))
    return arch, res, out, lj, gj


@pytest.mark.timeout(600)
def test_gloo_train_step_equals_one_process_and_jax(gloo_train):
    arch, res, out, jax_loss, jax_grads = gloo_train
    tol = GRAD_RTOL[arch]
    assert res["loss"] == pytest.approx(res["one_loss"], rel=1e-6)
    assert res["loss"] == pytest.approx(jax_loss, rel=1e-5)
    assert res["metrics"]["loss"] == pytest.approx(
        res["one_metrics"]["loss"], rel=1e-6)
    assert res["metrics"]["grad_norm"] == pytest.approx(
        res["one_metrics"]["grad_norm"], rel=2 * tol)
    assert set(jax_grads) == {k[2:] for k in out if k.startswith("g:")}
    for name, gj in jax_grads.items():
        scale = np.abs(gj).max()
        np.testing.assert_allclose(out[f"g:{name}"], out[f"og:{name}"],
                                   rtol=0, atol=tol * scale, err_msg=name)
        np.testing.assert_allclose(out[f"g:{name}"], gj, rtol=0,
                                   atol=tol * scale, err_msg=name)
        for mom in ("m", "v"):
            np.testing.assert_allclose(out[f"{mom}:{name}"],
                                       out[f"o{mom}:{name}"], rtol=0,
                                       atol=1e-5, err_msg=name)


@pytest.mark.timeout(600)
def test_gloo_collectives_equal_the_meta_count(gloo_train):
    res = gloo_train[1]
    real, meta = res["costs"], res["meta"]
    assert real["coll"] > 0 and real["n"] > 0
    assert real["coll"] == meta["coll"] and real["by_op"] == meta["by_op"]
    assert real["n"] == meta["n"] and real["flops"] == meta["flops"]
    # ZeRO-3: parameters gathered, gradients reduce-scattered
    assert {"all-gather", "reduce-scatter"} <= set(real["by_op"])


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch", ["gemma2_9b", "recurrentgemma_2b",
                                  "rwkv6_3b"])
def test_gloo_prefill_and_decode_equal_one_process(tmp_path, arch):
    _torch_mesh.run("gloo_serve", arch, str(tmp_path), timeout=600)
    out = np.load(tmp_path / "serve.npz")
    names = [k for k in out if not k.startswith("one:")]
    assert {"prefill", "decode"} < set(names) and len(names) > 2
    for k in names:
        want = out[f"one:{k}"]
        np.testing.assert_allclose(out[k], want, rtol=0,
                                   atol=SERVE_RTOL * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("knobs", [{}, {"yadt_rs": False,
                                        "yadt_compact": False}],
                         ids=["knobs_on", "knobs_off"])
@pytest.mark.parametrize("compact", [True, False])
def test_gloo_tree_superstep_equals_jax(tmp_path, compact, knobs):
    import jax.numpy as jnp

    from conftest import make_tree_dataset
    from repro.core import frontier as jf
    from repro.core.config import GrowConfig as JaxGrowConfig
    ds = make_tree_dataset(np.random.default_rng(0), 2000, n_cont=3,
                           n_disc=2, unknown_frac=0.05)
    prob = jf.FrontierProblem.from_dataset(
        ds, JaxGrowConfig(max_nodes=256, frontier_slots=8, compact=compact))
    path = tmp_path / "in.npz"
    np.savez(path, x=ds.x, y=ds.y, w=ds.w, cont=ds.attr_is_cont,
             n_bins=ds.n_bins.astype(np.int32), nbmax=prob.n_bins_max,
             n_classes=prob.n_classes, maxch=prob.max_children,
             compact=compact)
    _torch_mesh.run("gloo_tree", str(path), str(tmp_path), knobs,
                    timeout=600)
    out = np.load(tmp_path / "tree.npz")
    state = jf.init_state(prob, jnp.asarray(ds.y), jnp.asarray(ds.w))
    args = [jnp.asarray(a) for a in (ds.x, ds.y, ds.w, ds.attr_is_cont,
                                     ds.n_bins)]
    for _ in range(2):
        pre = jf.split_pre(state, prob=prob)
        att = jf.split_att(state, pre, *args, prob=prob, impl="jnp")
        state, _ = jf.split_post(state, pre, att, args[0], args[3], args[4],
                                 prob=prob)
    score, split_bin = jf._gains(att["hist"], pre["total_w"], args[3],
                                 args[4], prob=prob, impl="jnp")
    # the partitioned superstep equals the one-process port's bit for bit
    for k in ("hist", "score", "split_bin", "best_attr", "n_nodes",
              "node_attr", "node_class", "case_node"):
        np.testing.assert_array_equal(out[k], out[f"one:{k}"], err_msg=k)
    np.testing.assert_array_equal(out["hist"][:, :, :-1], att["hist"])
    np.testing.assert_array_equal(out["hist"][:, :, -1], att["unknown"])
    np.testing.assert_allclose(out["score"], score, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["split_bin"], split_bin)
    np.testing.assert_array_equal(out["best_attr"], att["best_attr"])
    assert int(out["n_nodes"]) == int(state.n_nodes) > 1
    m = prob.cfg.max_nodes
    np.testing.assert_array_equal(out["node_attr"][:m], state.tree.node_attr)
    np.testing.assert_array_equal(out["node_class"][:m],
                                  state.tree.node_class)
    np.testing.assert_array_equal(out["case_node"], state.case_node)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("knobs", [{}, {"yadt_compact": False}],
                         ids=["knobs_on", "compact_replicated"])
def test_gloo_tree_compaction_of_dead_cases_equals_one_process(tmp_path,
                                                               knobs):
    npz = _torch_mesh.tree_npz(compact=True)
    path = tmp_path / "in.npz"
    np.savez(path, **npz)
    _torch_mesh.run("gloo_tree", str(path), str(tmp_path), knobs, 4,
                    timeout=600)
    out = np.load(tmp_path / "tree.npz")
    # the fourth superstep's histogram leaves out cases in closed nodes
    n, a = npz["x"].shape
    assert 0 < out["hist"].sum() < n * a
    for k in ("hist", "score", "split_bin", "best_attr", "n_nodes",
              "node_attr", "node_class", "case_node"):
        np.testing.assert_array_equal(out[k], out[f"one:{k}"], err_msg=k)
