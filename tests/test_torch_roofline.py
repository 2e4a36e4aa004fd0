"""The H100 roofline of the port: one source for the card's peaks and the
kernels' bound formulas.  Each formula moved out of ``chip_smoke.py`` and
the profiles gives the value they computed inline before, at PERF.md
section 6's shapes; the roofline terms of a cell."""

import importlib.util
import itertools
from pathlib import Path

import pytest
import torch

from repro.launch import roofline as jrl
from repro_torch.launch import roofline as rl

ROOT = Path(__file__).resolve().parents[1]
# the constants chip_smoke.py and the profiles held before
OLD_HBM, OLD_F32, OLD_BF16 = 3.35e12, 67e12, 989e12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_bound(n_bytes, n_ops, ops=OLD_F32):
    t_bytes = n_bytes / OLD_HBM * 1e3
    t_ops = n_ops / ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _old_live_pairs(s, window):
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def test_peaks():
    assert (rl.HBM_BYTES_PER_S, rl.FP32_OPS_PER_S, rl.BF16_TENSOR_OPS_PER_S,
            rl.HBM_BYTES) == (OLD_HBM, OLD_F32, OLD_BF16, 80e9)
    assert rl.PEAK_FLOPS == OLD_BF16 and rl.HBM_BW == OLD_HBM


def test_live_pairs_count_the_causal_window():
    for s, w in itertools.product((1, 2, 7, 64, 300), (0, 1, 5, 64, 400)):
        brute = sum(min(q + 1, w) if w > 0 else q + 1 for q in range(s))
        assert rl.live_pairs(s, w) == brute == _old_live_pairs(s, w)


# PERF.md section 6 rows 4-5 and phase 7's layers:
# (B, S, H, KV, D, window, softcap, dtype)
FLASH = [(1, 7_000, 16, 8, 256, 0, 0.0, "bfloat16"),
         (1, 7_000, 16, 8, 256, 4_096, 50.0, "bfloat16"),
         (2, 4_096, 8, 4, 256, 0, 0.0, "bfloat16"),
         (2, 4_096, 8, 4, 256, 1_024, 0.0, "bfloat16"),
         (2, 4_096, 24, 8, 128, 0, 0.0, "bfloat16"),
         (1, 4_096, 24, 24, 64, 0, 0.0, "float32"),
         (1, 4_096, 10, 1, 256, 2_048, 0.0, "float32")]


@pytest.mark.parametrize("case", FLASH)
def test_flash_bounds_as_before(case):
    smoke = _chip_smoke()
    b, s, h, kv, d, window, _, dtype = case
    size = 2 if dtype == "bfloat16" else 4
    fwd = _old_bound((2 * b * s * h * d + 2 * b * s * kv * d) * size,
                     4 * b * h * d * _old_live_pairs(s, window), OLD_BF16)
    assert smoke._flash_bound(case) == fwd
    bwd = _old_bound(
        (4 * b * s * h * d + 4 * b * s * kv * d) * size + b * h * s * 4,
        10 * b * h * d * _old_live_pairs(s, window), OLD_BF16)
    assert smoke._bwd_bound(case[:7], dtype) == bwd
    # profile_flash_bwd's operations bound
    assert rl.bound_ms(0, rl.flash_bwd_flops(b, s, h, d, window),
                       rl.BF16_TENSOR_OPS_PER_S)[0] == (
        10 * b * h * d * _old_live_pairs(s, window) / OLD_BF16 * 1e3)


# (N, A, non-zero cells, K, B + 1, C): SyD10M9A's root, census_pums' shape
HIST = [(10_000_000, 9, 3_000, 256, 257, 2), (299_285, 40, 9_000, 256, 129,
                                              2), (1, 9, 1, 1, 257, 2)]


@pytest.mark.parametrize("n,a,nz,k,b1,c", HIST)
def test_histogram_bounds_as_before(n, a, nz, k, b1, c):
    smoke = _chip_smoke()
    for cells in (nz, k * a * b1 * c):
        old = _old_bound(n * (4 * a + 12) + cells * 4, n * a)
        assert smoke.bound(rl.histogram_bytes(n, a, cells),
                           rl.histogram_ops(n, a)) == old


@pytest.mark.parametrize("k,a,b,c", [(256, 9, 256, 2), (256, 40, 128, 2),
                                     (16, 6, 13, 23), (1, 9, 256, 2)])
def test_split_gain_bounds_as_before(k, a, b, c):
    old_bytes = k * a * b * c * 4 + k * 4 + a * 5 + k * a * 8
    old_ops = k * a * b * (6 * c + 20)
    assert (rl.split_gain_bytes(k, a, b, c), rl.split_gain_ops(k, a, b, c)
            ) == (old_bytes, old_ops)
    assert _chip_smoke().bound(old_bytes, old_ops) == _old_bound(old_bytes,
                                                                 old_ops)


def test_traversal_bound_as_before():
    from repro_torch import profile_infer
    tab_np, depth = profile_infer.small_trees(64, 9, seed=0, n_bins=16)
    tab = torch.from_numpy(tab_np)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-1, 16, (500, 9), generator=gen, dtype=torch.int32)
    cont = torch.tensor([True, False] * 4 + [True])
    got = profile_infer.traversal_bound(tab, x, cont, depth)
    n, a = x.shape
    old_bytes = n * a * 4 + got["rows_visited"] * 32 + 64 * n * 4
    t_bytes = old_bytes / OLD_HBM * 1e3
    t_ops = 6 * got["steps"] / OLD_F32 * 1e3
    assert got["bytes"] == old_bytes
    assert (got["bound_ms"], got["bound_by"]) == (
        max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    assert (got["bytes_ms"], got["operations_ms"]) == (t_bytes, t_ops)


def test_no_copy_of_the_peaks_outside_the_roofline():
    for path in [ROOT / "chip_smoke.py",
                 *sorted((ROOT / "src/repro_torch").rglob("*.py"))]:
        if path.name == "roofline.py":
            continue
        text = path.read_text()
        for literal in ("3.35e12", "67e12", "989e12"):
            assert literal not in text, (path, literal)


def test_roofline_terms():
    r = rl.Roofline(arch="gemma3_4b", shape="train_4k", mesh="1",
                    device_flops=2.0e14, device_bytes=1.0e12,
                    device_coll_bytes=0.0, coll_by_op={},
                    peak_mem_bytes=None, arg_bytes=5e10,
                    model_flops=1.5e14, min_bytes=9e10)
    assert r.t_compute == 2.0e14 / OLD_BF16 and r.t_collective == 0.0
    assert r.bound_s == r.t_compute and r.bound_by == "operations"
    assert r.t_memory == 1.0e12 / OLD_HBM and r.bottleneck == "memory"
    d = r.as_dict(1)
    jkeys = jrl.Roofline("a", "s", "m", 1.0, 1.0, 1.0, {}, 1.0, 1.0,
                         1.0).as_dict(1)
    assert set(jkeys) <= set(d) and d["peak_mem_gb"] is None
    bw, link = rl.collective_rate(256)
    mesh = rl.Roofline("a", "s", "16x16", 1e12, 1e9, 5e10,
                       {"all-gather": 5e10}, None, 1e9, 1e14, min_bytes=1e12,
                       coll_bw=bw, coll_link=link)
    assert mesh.t_collective == 5e10 / 50e9 and link == "nic_400g"
    assert mesh.bottleneck == "collective" and mesh.bound_by == "bytes"
    assert mesh.roofline_seconds == mesh.t_collective
    assert mesh.useful_flops_ratio(256) == 1e14 / (1e12 * 256)
    assert rl.collective_rate(8) == (450e9, "nvlink4")
    assert rl.collective_rate(1) == (450e9, "nvlink4")


def test_analyze_splits_evenly_and_picks_the_peak():
    """A mesh's counts are a partitioned step's, one device's own: analyze
    divides nothing, and takes the collective term at the mesh's rate."""
    c = rl.Costs(device_flops=256e12, device_bytes=512e9, arg_bytes=256e9,
                 out_bytes=0.0, n_ops=10, coll_bytes=3e9,
                 coll_by_op={"all-gather": 1e9, "reduce-scatter": 2e9})
    r = rl.analyze(c, arch="yi_6b", shape="train_4k", mesh_desc="16x16",
                   n_devices=256)
    assert r.device_flops == 256e12 and r.device_coll_bytes == 3e9
    assert r.coll_by_op == c.coll_by_op and r.coll_link == "nic_400g"
    assert r.t_collective == 3e9 / 50e9
    assert r.min_bytes == 256e9 and r.peak_flops == OLD_BF16
    assert rl.analyze(c, arch="yi_6b", shape="train_4k", mesh_desc="2x4",
                      n_devices=8).t_collective == 3e9 / 450e9
    y = rl.analyze(c, arch="yadt", shape="train_4k", mesh_desc="1",
                   n_devices=1)
    assert y.peak_flops == OLD_F32 and y.model_flops == 0.0
    assert rl.model_flops_for("yi_6b", "train_4k", batch=2) * 128 == (
        rl.model_flops_for("yi_6b", "train_4k"))


@pytest.mark.parametrize("n,live,waiting,changed,want_ms", [
    (10_000_000, 10_000_000, 0, 0, 0.0358),
    (10_000_000, 21_620, 0, 0, 0.0120), (1, 0, 0, 0, 0.0),
    (10_000_000, 10_000_000, 0, 10_000_000, 0.0478),
    (10_000_000, 21_620, 1_000_000, 500_000, 0.0138)],
    ids=["syd-root", "syd-superstep-500", "n1-closed", "syd-root-ahead",
         "syd-superstep-500-ahead"])
def test_split_post_bound_counts_slots_and_live_cases(n, live, waiting,
                                                      changed, want_ms):
    """splitPost's bound: 4 bytes of slot a case, 8 of bin and node a live
    case, and writing the next frontier 4 of node a waiting case and 4 a
    changed slot, at the f32 rate's byte side (PERF.md section 6's row)."""
    got = _chip_smoke().bound(
        rl.split_post_bytes(n, live, waiting, changed), 0)
    assert got == ((4 * n + 8 * live + 4 * waiting + 4 * changed)
                   / OLD_HBM * 1e3, "bytes")
    assert got[0] == pytest.approx(want_ms, abs=5e-5)


@pytest.mark.parametrize("n,live,waiting,changed,listed", [
    (10_000_000, 10_000_000, 0, 10_000_000, 10_000_000),
    (10_000_000, 21_620, 1_000_000, 500_000, 20_000), (1, 0, 0, 0, 0)],
    ids=["syd-root-listed", "syd-superstep-500-listed", "n1-none-listed"])
def test_split_post_bound_counts_listed_cases(n, live, waiting, changed,
                                              listed):
    """Writing the next superstep's live list, the routing kernel writes
    4 bytes of index a listed case, on top of the bound without a list."""
    assert rl.split_post_bytes(n, live, waiting, changed, listed) == (
        rl.split_post_bytes(n, live, waiting, changed) + 4 * listed)
    assert rl.split_post_bytes(n, live, waiting, changed, listed) == (
        4 * n + 8 * live + 4 * waiting + 4 * changed + 4 * listed)


@pytest.mark.parametrize("listed", [0, 137, 1000])
def test_histogram_through_a_list_counts_the_listed_cases_on_meta(listed):
    """The histogram's op read through a list of cases counts one add per
    (listed case, attribute) and reads each listed case's row, label,
    weight, slot and index once; on meta tensors it launches nothing."""
    from repro_torch.kernels import histogram
    n, a, k, nb, c = 1000, 9, 16, 32, 2
    meta = dict(device="meta")
    x = torch.empty((n, a), dtype=torch.int32, **meta)
    v = torch.empty((n,), dtype=torch.int32, **meta)
    w = torch.empty((n,), **meta)
    before = histogram.LAUNCHES
    hist, cost = rl.count_costs(
        lambda *t: histogram.frontier_histogram(
            *t[:4], n_slots=k, n_bins=nb, n_classes=c, case_list=t[4],
            n_listed=listed), x, v, w, v, v)
    assert hist.shape == (k, a, nb + 1, c) and histogram.LAUNCHES == before
    cells = k * a * (nb + 1) * c
    assert cost.device_flops == rl.histogram_ops(listed, a) == listed * a
    assert cost.device_bytes == rl.histogram_bytes(listed, a, cells,
                                                   listed=True)
    assert cost.device_bytes == listed * (4 * a + 16) + 4 * cells


@pytest.mark.parametrize("bad,match", [
    (dict(n_listed=5), "without a case_list"),
    (dict(case_list="v", n_listed=None), "outside the list"),
    (dict(case_list="v", n_listed=1001), "outside the list"),
    (dict(case_list="v64", n_listed=3), "must be int32")])
def test_histogram_refuses_a_malformed_list(bad, match):
    from repro_torch.kernels import histogram
    n, a = 1000, 9
    x = torch.empty((n, a), dtype=torch.int32, device="meta")
    v = torch.empty((n,), dtype=torch.int32, device="meta")
    w = torch.empty((n,), device="meta")
    lists = {"v": v, "v64": v.long()}
    kw = {key: lists.get(val, val) if key == "case_list" else val
          for key, val in bad.items()}
    with pytest.raises((TypeError, ValueError), match=match):
        histogram.frontier_histogram(x, v, w, v, n_slots=4, n_bins=8,
                                     n_classes=2, **kw)
