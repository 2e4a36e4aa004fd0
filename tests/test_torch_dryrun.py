"""The port's dry run on meta tensors, at reduced configs and shrunk shapes
(tests/test_dryrun_small.py's cells), its report and the markdown
injection against the JAX package's, and the hillclimb command.  A mesh
run (its fake process group) goes to a subprocess of its own
(``tests/_torch_mesh.py``)."""

import json
import re
from pathlib import Path

import pytest
import torch

import _torch_mesh
from repro.launch import report as jreport
from repro.launch import update_experiments as jupdate
from repro_torch.configs import base
from repro_torch.kernels import flash_attention, histogram, ref, split_gain
from repro_torch.launch import (dryrun, hillclimb, report, roofline,
                                update_experiments)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("yi_6b", "train_4k"), ("phi35_moe", "train_4k"),
         ("gemma2_9b", "decode_32k"), ("rwkv6_3b", "long_500k"),
         ("recurrentgemma_2b", "prefill_32k")]
JAX_KEYS = ("arch", "shape", "mesh", "device_flops", "device_bytes",
            "device_coll_bytes", "coll_by_op", "t_compute", "t_memory",
            "t_collective", "bottleneck", "peak_mem_gb", "arg_gb",
            "model_flops", "useful_flops_ratio", "status", "t_prod_s",
            "mem_args_gb", "mem_temp_gb", "mem_out_gb", "t_analysis_s")


@pytest.fixture
def small(monkeypatch):
    """tests/test_dryrun_small.py's shrunk shapes and reduced configs."""
    shapes = {
        "train_4k": base.ShapeSpec("train_4k", 128, 8, "train"),
        "prefill_32k": base.ShapeSpec("prefill_32k", 256, 4, "prefill"),
        "decode_32k": base.ShapeSpec("decode_32k", 256, 8, "decode"),
        "long_500k": base.ShapeSpec("long_500k", 512, 1, "decode"),
    }
    real = base.get_config
    reduced = {a: base.reduced(real(a)) for a in base.ARCH_IDS}
    monkeypatch.setattr(base, "SHAPES", shapes)
    monkeypatch.setattr(base, "get_config",
                        lambda a: reduced[a] if a in reduced else real(a))
    return reduced


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mesh", ["1", "16x16"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_small_cells_count_on_meta(small, arch, shape, mesh):
    if mesh == "1":
        r = dryrun.run_cell(arch, shape, mesh=mesh, verbose=False)
    else:
        res = _torch_mesh.run("cell", arch, shape, mesh, timeout=300)
        r, one = res["mesh"], res["one"]
    assert r["status"] == "ok" and r["device"] == "meta"
    assert r["device_flops"] > 0 and r["device_bytes"] > 0
    assert set(JAX_KEYS) <= set(r)
    assert r["mem_temp_gb"] is None and r["peak_mem_gb"] is None
    assert r["bound_s"] == max(r["t_compute"], r["t_min_bytes"]) > 0
    if mesh == "1":
        assert r["t_collective"] == 0.0 and r["split"] is None
        assert r["device_coll_bytes"] == 0.0 and r["coll_by_op"] == {}
    else:
        # partitioned: one device's own counts, its collectives over the
        # NICs of a 256-card mesh
        assert r["split"] == "partitioned" and r["coll_link"] == "nic_400g"
        assert r["device_coll_bytes"] > 0
        assert r["device_coll_bytes"] == sum(r["coll_by_op"].values())
        assert r["t_collective"] == r["device_coll_bytes"] / r["coll_bw"]
        assert 0 < r["device_flops"] <= one["device_flops"]
        assert r["device_flops"] != one["device_flops"] / 256
        assert r["mem_args_gb"] < one["mem_args_gb"]


def test_dense_prefill_flops_equal_a_count_by_hand(small):
    """yi_6b reduced, 4 x 256 tokens: the matmuls (q, k, v, o, the gated
    MLP, the last position's unembedding) plus the flash formula."""
    cfg = base.get_config("yi_6b")
    shape = base.SHAPES["prefill_32k"]
    b, s = shape.global_batch, shape.seq_len
    t = b * s
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    layer = (2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
             + 3 * 2 * t * d * f
             + roofline.flash_fwd_flops(b, s, h, hd, 0))
    want = cfg.n_layers * layer + 2 * b * d * cfg.vocab_size
    r = dryrun.run_cell("yi_6b", "prefill_32k", verbose=False)
    assert r["device_flops"] == want


def test_dense_decode_flops_equal_a_count_by_hand(small):
    cfg = base.get_config("yi_6b")
    shape = base.SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    layer = (2 * b * d * (h + 2 * kv) * hd + 2 * b * h * hd * d
             + 3 * 2 * b * d * f + 2 * 2 * b * h * hd * s)
    want = cfg.n_layers * layer + 2 * b * d * cfg.vocab_size
    r = dryrun.run_cell("yi_6b", "decode_32k", verbose=False)
    assert r["device_flops"] == want


def test_meta_never_reaches_the_plain_versions(small, monkeypatch):
    called = []
    for name in dir(ref):
        fn = getattr(ref, name)
        if callable(fn) and getattr(fn, "__module__", "") == ref.__name__:
            monkeypatch.setattr(
                ref, name, lambda *a, _n=name, _f=fn, **k: called.append(_n)
                or _f(*a, **k))
    before = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_BWD,
              histogram.LAUNCHES, split_gain.LAUNCHES)
    for arch, shape in CELLS:
        assert dryrun.run_cell(arch, shape, verbose=False)["status"] == "ok"
    assert not called
    assert (flash_attention.LAUNCHES, flash_attention.LAUNCHES_BWD,
            histogram.LAUNCHES, split_gain.LAUNCHES) == before
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ref.flash_attention_ref(q, q, q)


def test_flash_counts_its_formula_on_meta():
    b, s, h, kv, d, window = 2, 300, 4, 2, 64, 100
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kv, d), dtype=torch.bfloat16, device="meta")
    from repro_torch.kernels import ops
    out, c = roofline.count_costs(
        lambda q, k, v: ops.flash_attention(q, k, v, window=window), q, k, k)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_meta
    flops = roofline.flash_fwd_flops(b, s, h, d, window)
    assert c.device_flops == flops
    # the scale of q (an elementwise op), then the kernel's own bytes
    assert c.device_bytes == (2 * q.numel() * 2 + 2 + roofline.flash_fwd_bytes(
        b, s, h, kv, d, 2))
    grads = {}

    def fwd_bwd(q, k, v):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        from repro_torch.models import layers
        spec = layers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=d,
                               d_model=h * d, window=window)
        o = layers.blockwise_attention(q, k, v, spec=spec)
        grads["g"] = torch.autograd.grad(o.sum(), (q, k, v))
        return o

    _, c = roofline.count_costs(fwd_bwd, q.clone(), k.clone(), k.clone())
    assert c.device_flops == flops + roofline.flash_bwd_flops(b, s, h, d,
                                                              window)
    assert [g.shape for g in grads["g"]] == [q.shape, k.shape, k.shape]


def test_tree_kernels_count_their_formulas_on_meta():
    from repro_torch.kernels import ops
    n, a, k, nb, c = 1000, 9, 16, 32, 2
    meta = dict(device="meta")
    x = torch.empty((n, a), dtype=torch.int32, **meta)
    v = torch.empty((n,), dtype=torch.int32, **meta)
    w = torch.empty((n,), **meta)
    hist, cost = roofline.count_costs(
        lambda *t: ops.frontier_histogram(*t, n_slots=k, n_bins=nb,
                                          n_classes=c), x, v, w, v)
    assert hist.shape == (k, a, nb + 1, c) and hist.dtype == torch.float32
    assert cost.device_flops == roofline.histogram_ops(n, a)
    assert cost.device_bytes == roofline.histogram_bytes(
        n, a, k * a * (nb + 1) * c)
    h4 = torch.empty((k, a, nb, c), **meta)
    (score, sbin), cost = roofline.count_costs(
        lambda *t: ops.split_gain(*t), h4, torch.empty((k,), **meta),
        torch.empty((a,), dtype=torch.bool, **meta),
        torch.empty((a,), dtype=torch.int32, **meta))
    assert score.shape == sbin.shape == (k, a) and sbin.dtype == torch.int32
    assert cost.device_flops == roofline.split_gain_ops(k, a, nb, c)
    assert cost.device_bytes == roofline.split_gain_bytes(k, a, nb, c)
    tab = torch.empty((4, 63, 8), dtype=torch.int32, **meta)
    out, cost = roofline.count_costs(
        lambda *t: ops.forest_predict(*t, max_depth=5), tab, x,
        torch.empty((a,), dtype=torch.bool, **meta))
    assert out.shape == (4, n) and out.dtype == torch.int32
    assert cost.device_flops == roofline.traversal_ops(4 * n * 5)
    assert cost.device_bytes == roofline.traversal_bytes(n, a, 4, 4 * 63)


def test_yadt_cell_needs_the_device_on_meta():
    r = dryrun.run_cell("yadt", "train_4k", verbose=False)
    assert r["status"] == "needs_device" and r["op"] == "aten::nonzero"
    m = re.fullmatch(r"repro_torch/(core/frontier\.py):(\d+)", r["where"])
    assert m, r["where"]
    line = (ROOT / "src/repro_torch" / m.group(1)).read_text().splitlines()[
        int(m.group(2)) - 1]
    assert "nonzero" in line
    assert r["batch"] == 10_000_384 and r["mem_args_gb"] > 0.4


@pytest.mark.timeout(300)
def test_dryrun_main_writes_the_json(tmp_path):
    out = tmp_path / "dry.json"
    shown = _torch_mesh.run("main", str(out), timeout=300)
    res = json.loads(out.read_text())
    r = res["gemma2_9b/decode_32k"]
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    assert r["split"] == "partitioned" and r["t_collective"] > 0
    text = report.render(str(out))
    assert text == shown["render"] and "not measured" in text
    assert f"| {r['t_collective'] * 1e3:.1f} |" in text
    assert report.summarize(str(out)) == shown["summary"] == "1/1 cells OK"


def _jax_shaped(path):
    res = {
        "yi_6b/train_4k": dict(
            status="ok", arch="yi_6b", shape="train_4k", t_compute=0.01234,
            t_memory=0.0456, t_collective=0.00789, bottleneck="memory",
            useful_flops_ratio=0.734, mem_temp_gb=12.345),
        "phi35_moe/decode_32k": dict(status="fail",
                                     error="ValueError: " + "x" * 80),
        "gemma2_9b/prefill_32k": dict(status="ok", mem_temp_gb=3.21),
    }
    path.write_text(json.dumps(res))
    return str(path)


def test_report_of_a_jax_json_equals_the_jax_report(tmp_path):
    p = _jax_shaped(tmp_path / "r.json")
    assert report.render(p) == jreport.render(p)
    assert report.summarize(p) == jreport.summarize(p)


def test_report_renders_the_ports_statuses(tmp_path):
    p = tmp_path / "r.json"
    p.write_text(json.dumps({
        "yadt/train_4k": dict(status="needs_device",
                              error="needs_device: aten::nonzero at x:1"),
        "llama4_scout/train_4k": dict(
            status="does_not_fit", arch="llama4_scout", shape="train_4k",
            t_compute=1.0, t_memory=2.0, t_collective=0.0,
            bottleneck="memory", useful_flops_ratio=0.5, mem_temp_gb=None,
            mem_args_gb=1077.7)}))
    text = report.render(str(p))
    assert "NEEDS DEVICE" in text and "does not fit: args 1077.7 GB" in text
    assert "not measured" in text
    assert report.summarize(str(p)) == (
        "0/2 cells OK\ndo not fit: llama4_scout/train_4k\n"
        "need the device: yadt/train_4k")


@pytest.mark.parametrize("closed", [True, False])
def test_inject_writes_what_the_jax_package_writes(tmp_path, closed):
    p = _jax_shaped(tmp_path / "r.json")
    body = ("# EXPERIMENTS\n\n<!-- DRYRUN-SUMMARY -->\n"
            + ("old\n<!-- /DRYRUN-SUMMARY -->\n" if closed else "")
            + "\ntext\n<!-- ROOFLINE-TABLE -->\n"
            + ("| stale |\n<!-- /ROOFLINE-TABLE -->\n" if closed else ""))
    ours, theirs = tmp_path / "ours.md", tmp_path / "theirs.md"
    for md in (ours, theirs):
        md.write_text(body)
    for mod, md in ((update_experiments, ours), (jupdate, theirs)):
        mod.inject(str(md), "DRYRUN-SUMMARY", mod.report.summarize(p))
        mod.inject(str(md), "ROOFLINE-TABLE", mod.report.render(p))
    assert ours.read_text() == theirs.read_text()
    assert "<!-- /ROOFLINE-TABLE -->" in ours.read_text()


@pytest.mark.timeout(300)
def test_hillclimb_knobs_change_nothing():
    """The knobs change the partitioned count: moe2d shards the experts'
    capacity axis over DP, as in the JAX lowering.  (The name is from
    before the step was partitioned, when the knobs changed nothing; it is
    kept so that the test's record carries on.)"""
    res = _torch_mesh.run("hillclimb", "phi35_moe", "train_4k",
                          {"moe2d": True, "kv_seq_shard": True}, timeout=300)
    plain, knob = res["plain"], res["knob"]
    assert knob["knobs"] == {"moe2d": True, "kv_seq_shard": True}
    assert plain["flops"] > 0 and plain["coll"] > 0
    assert plain["coll_by_op"] != knob["coll_by_op"]
    assert knob["flops"] < plain["flops"]
    for r in (plain, knob):
        assert r["coll"] == sum(r["coll_by_op"].values())
        assert r["t_collective_ms"] == (r["coll"] / roofline.NIC_BYTES_PER_S
                                        * 1e3)
    assert hillclimb.parse_knobs(["moe2d", "yadt_rs=false", "x=3"]) == {
        "moe2d": True, "yadt_rs": False, "x": 3}
