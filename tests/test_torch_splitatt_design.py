"""The design of the CUDA splitAtt kernels, held on the CPU.

The kernels run only on the card; what surrounds them is Python that runs
here: the launch plans (``repro_torch.kernels.autotune``) and torch
emulations of each kernel's decomposition, step for step as the CUDA code
takes it:

  histogram:  tiles of block_t cases walked by `blocks` blocks (grid
              stride), per window of block_k live slots; each (attribute,
              case) pair added straight into the output (direct plan, once
              per (warp, cell) with the lanes' sum) or into a window of
              slot rows in shared memory (shared plan: integral parts as
              integer counts, fractions to the output), the window's
              non-zero counts added once a block.  Held against the JAX
              package's plain histogram and its Pallas kernel in interpret
              mode: exact for integral weights (f32 sums of integers below
              2^24 in any order), atol 1e-4 / rtol 1e-5 for random f32
              weights.
  split gain: per (slot, attribute) row, 32 lane segments of seg bins per
              class (in registers or in shared memory); segment sums, a
              Hillis-Steele shuffle scan of the lane totals, the serial
              in-place scan; each lane's first maximum, then a butterfly
              argmax keeping the lower bin on ties; the discrete sums as
              butterfly shuffle sums.  Held against
              the port's ``entropy.gains_from_histogram`` (the kernel's
              specification): bins and the -inf pattern exact, scores
              within 1e-5 * (1 + |score|) (the discrete branch adds its bins
              in another order), continuous scores exact on integral counts
              (the scan of integers is exact and each bin's arithmetic is
              the scorer's, op for op); and against
              ``repro.core.entropy.gains_from_histogram``: bins and -inf
              exact, scores within the port's own tolerance to it,
              1e-5 * (1 + |score|) for the gain and 1e-4 for the ratio.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entropy as jentropy
from repro.kernels import histogram as jhist
from repro.kernels import ref as jref
from repro_torch.core import entropy
from repro_torch.kernels import autotune

EPS_W = 1e-7
SMEM_MAX = 232_448


# --------------------------------------------------------------------------
# the planner at the build's real shapes
# --------------------------------------------------------------------------

SYD = dict(n_slots=256, n_bins=256, n_classes=2, n_attrs=9)
CENSUS = dict(n_slots=256, n_bins=128, n_classes=2, n_attrs=40)


def test_plan_root_superstep_is_shared():
    """All 10M cases in slot 0: one window of one slot row (18.5 KB of
    int32 counts), one wave of blocks."""
    p = autotune.plan_histogram(n_cases=10_000_000, n_live_slots=1, **SYD)
    assert (p.mode, p.live, p.block_k, p.windows) == ("shared", 1, 1, 1)
    row = 4 * 9 * 257 * 2
    assert p.smem == p.block_t * 2 * 4 * (9 + 3) + row
    assert p.smem <= autotune.HIST_SMEM_BUDGET
    assert p.blocks == 3 * autotune.H100_SMS          # three blocks an SM
    assert p.blocks * p.block_t < 10_000_000          # blocks loop over tiles


def test_plan_average_deep_superstep_is_direct():
    """134,664 live cases over 256 slots (the build's average launch):
    about one case per cell, so adds go straight to device memory, a warp's
    lanes of one cell aggregated; one block per tile, no window, no
    flush."""
    p = autotune.plan_histogram(n_cases=134_664, n_live_slots=256, **SYD)
    assert (p.mode, p.block_k, p.windows) == ("direct", 0, 1)
    assert p.blocks == -(-134_664 // p.block_t)
    assert p.smem == p.block_t * 2 * 4 * (9 + 3)    # two tiles, no window


def test_plan_census_shapes():
    root = autotune.plan_histogram(n_cases=299_285, n_live_slots=1, **CENSUS)
    row = 4 * 40 * 129 * 2                         # 41,280 B a slot
    assert root.mode == "shared"
    tile = root.block_t * 2 * 4 * (41 + 3)        # two tiles of padded rows
    assert root.smem == tile + row
    deep = autotune.plan_histogram(n_cases=3_000, n_live_slots=256, **CENSUS)
    assert deep.mode == "direct"
    # the tiles of 41-word rows stay small enough for two blocks an SM
    assert tile <= autotune.HIST_TILE_BYTES and root.smem <= (
        autotune.HIST_SMEM_BUDGET)


@pytest.mark.parametrize("seed", range(4))
def test_plan_never_exceeds_shared_memory(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        kw = dict(n_cases=int(rng.integers(1, 20_000_000)),
                  n_slots=int(rng.integers(1, 512)),
                  n_bins=int(rng.integers(1, 400)),
                  n_classes=int(rng.integers(1, 30)),
                  n_attrs=int(rng.integers(1, 64)))
        kw["n_live_slots"] = int(rng.integers(0, kw["n_slots"] + 2))
        try:
            p = autotune.plan_histogram(**kw)
        except ValueError:
            continue
        assert p.smem <= SMEM_MAX
        assert 1 <= p.live <= kw["n_slots"]
        assert p.blocks >= 1 and p.windows * max(p.block_k, 1) >= (
            p.live if p.block_k else 1)
        if p.mode == "shared":
            assert p.windows == -(-p.live // p.block_k)


def test_plan_pins_are_honoured_or_refused():
    p = autotune.plan_histogram(n_cases=10_000_000, n_live_slots=1,
                                block_k=0, **SYD)
    assert p.mode == "direct"
    p = autotune.plan_histogram(n_cases=1_000, n_live_slots=7, block_k=2,
                                block_t=64, **SYD)
    assert (p.mode, p.block_k, p.block_t, p.windows) == ("shared", 2, 64, 4)
    with pytest.raises(ValueError):
        autotune.plan_histogram(n_cases=1_000, block_t=4_000, **CENSUS)
    with pytest.raises(ValueError):                  # 12 slot rows > 227 KB
        autotune.plan_histogram(n_cases=1_000, n_live_slots=20, block_k=12,
                                **SYD)
    with pytest.raises(ValueError):
        autotune.plan_histogram(n_cases=1_000, block_k=-1, **SYD)


def test_plan_split_gain():
    p = autotune.plan_split_gain(n_bins=256, n_classes=2)
    assert (p.warps, p.regs, p.seg, p.smem, p.threads) == (2, True, 8, 0, 64)
    # census_pums (B = 128) and a few bins: the register kernel's segments
    assert autotune.plan_split_gain(n_bins=128, n_classes=2).seg == 4
    assert autotune.plan_split_gain(n_bins=13, n_classes=2).seg == 1
    for b, c in ((257, 2), (13, 3), (300, 23)):    # the shared-memory one
        q = autotune.plan_split_gain(n_bins=b, n_classes=c)
        assert not q.regs and q.seg == -(-b // 32) and q.seg_pad % 2 == 1
    wide = autotune.plan_split_gain(n_bins=300, n_classes=23)
    assert wide.seg_pad % 2 == 1 and wide.smem <= SMEM_MAX
    assert wide.warps * 23 * 32 * wide.seg_pad * 4 == wide.smem
    assert autotune.plan_split_gain(n_bins=8, n_classes=2,
                                    block_b=64).warps == 2
    for bad in (48, 2048):
        with pytest.raises(ValueError):
            autotune.plan_split_gain(n_bins=8, n_classes=2, block_b=bad)
    with pytest.raises(ValueError):
        autotune.plan_split_gain(n_bins=300, n_classes=23, block_b=256)
    with pytest.raises(ValueError):
        autotune.plan_split_gain(n_bins=4096, n_classes=64)


# --------------------------------------------------------------------------
# histogram: the kernel's decomposition, emulated
# --------------------------------------------------------------------------

def emulate_histogram(x, y, w, slot, *, n_slots, n_bins, n_classes, plan):
    """What csrc/histogram.cu computes under ``plan``, block by block."""
    n, a_dim = x.shape
    cells = (n_bins + 1) * n_classes
    row = a_dim * cells
    shared = plan.block_k > 0
    out = torch.zeros(n_slots * row, dtype=torch.float32)
    for wy in range(plan.windows):
        k0 = wy * plan.block_k
        kb = min(plan.block_k, plan.live - k0) if shared else 0
        n_sub = kb * row
        for bx in range(plan.blocks):
            sub = torch.zeros(n_sub, dtype=torch.int64)     # int32 counts
            for t0 in range(bx * plan.block_t, n, plan.blocks * plan.block_t):
                cnt = min(plan.block_t, n - t0)
                s = slot[t0:t0 + cnt].long()
                c = y[t0:t0 + cnt].long()
                valid = (c >= 0) & (c < n_classes) & (s >= 0) & (s < n_slots)
                direct = 2 * (s * row + c)
                if not shared:
                    code = torch.where(valid, direct, -1)
                else:
                    inwin = valid & (s - k0 >= 0) & (s - k0 < kb)
                    glob = valid & ~inwin & (s >= plan.live) & (wy == 0)
                    code = torch.where(inwin, 2 * ((s - k0) * row + c) + 1,
                                       torch.where(glob, direct, -1))
                j = torch.arange(cnt * a_dim)
                a, i = j // cnt, j % cnt
                b = x[t0 + i, a].long()
                b = torch.where(b < 0, n_bins, b)
                v = code[i]
                ok = (v >= 0) & (b <= n_bins)
                key = (v + 2 * (a * cells + b * n_classes))[ok]
                wt = w[t0 + i][ok]
                if not shared:
                    # one add per (warp, key): the warp's lanes are the 32
                    # consecutive pairs of one pass of the block
                    warp_key = (j[ok] // 32) * 2 ** 40 + key
                    uniq, inv = torch.unique(warp_key, return_inverse=True)
                    wt = torch.zeros(uniq.numel()).index_add_(0, inv, wt)
                    key = uniq % 2 ** 40
                off, local = key >> 1, key & 1 == 1
                out.index_add_(0, off[~local], wt[~local])
                # the window: integral parts as integers, fractions to the
                # output
                wl = wt[local]
                ip = torch.where(wl.abs() < 256, torch.trunc(wl), 0.0)
                sub.index_add_(0, off[local], ip.long())
                frac = wl - ip
                out.index_add_(0, k0 * row + off[local][frac != 0],
                               frac[frac != 0])
            if shared:
                nz = torch.nonzero(sub).flatten()
                out.index_add_(0, k0 * row + nz, sub[nz].float())
    return out.view(n_slots, a_dim, n_bins + 1, n_classes)


def _hist_inputs(rng, n, a, b, c, k, live, *, integral, low_card=False):
    x = rng.integers(-1, b, (n, a)).astype(np.int32)
    if low_card:   # SyD-like discrete columns: 5, 9 and 20 values
        for col, card in zip(range(a - 3, a), (5, 9, 20)):
            x[:, col] = rng.integers(0, min(card, b), n)
    y = rng.integers(0, c, n).astype(np.int32)
    w = (rng.integers(0, 4, n) if integral
         else rng.uniform(0.1, 2.0, n)).astype(np.float32)
    slot = rng.integers(-1, live, n).astype(np.int32)
    return x, y, w, slot


# (N, A, B, C, K, live slots, pins): the regimes of the kernel at small size
HIST_CASES = [
    (3_000, 9, 16, 2, 8, 1, {}),                    # root: one slot, shared
    (3_000, 9, 16, 2, 8, 1, dict(block_t=128)),     # ... several tiles a block
    (2_000, 9, 16, 2, 8, 8, {}),                    # sparse: direct
    (2_000, 9, 16, 2, 8, 8, dict(block_k=3, block_t=256)),  # 3 windows
    (1_500, 6, 20, 3, 16, 4, dict(block_k=2, block_t=64)),
    (700, 40, 12, 2, 6, 6, dict(block_t=96)),       # wide A: padded stride
    (400, 4, 7, 23, 5, 5, {}),                      # many classes
    (1, 2, 1, 2, 1, 1, {}),                         # n = 1
    (900, 3, 9, 2, 1, 1, {}),                       # K = 1
    (3_000, 9, 16, 2, 8, 1, dict(block_k=0)),        # dense, direct
]


@pytest.mark.parametrize("n,a,b,c,k,live,pins", HIST_CASES)
@pytest.mark.parametrize("integral", [True, False])
def test_histogram_emulation_matches_jax(n, a, b, c, k, live, pins,
                                         integral):
    rng = np.random.default_rng(n * 7 + a)
    x, y, w, slot = _hist_inputs(rng, n, a, b, c, k, live,
                                 integral=integral, low_card=a >= 6)
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    plan = autotune.plan_histogram(n_cases=n, n_attrs=a, n_live_slots=live,
                                   **kw, **pins)
    got = emulate_histogram(*map(torch.as_tensor, (x, y, w, slot)),
                            plan=plan, **kw).numpy()
    want = np.asarray(jref.frontier_histogram_ref(x, y, w, slot, **kw))
    pallas = np.asarray(jhist.frontier_histogram(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(slot),
        block_t=256, block_k=4, block_b=32, interpret=True, **kw))
    if integral:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-5)


def test_histogram_emulation_counts_cases_beyond_the_live_hint():
    """A case whose slot lies at or above ``n_live_slots`` is still
    counted (by window 0's device adds), so the hint never drops data."""
    rng = np.random.default_rng(5)
    x, y, w, slot = _hist_inputs(rng, 2_000, 5, 10, 3, 12, 12,
                                 integral=True)
    kw = dict(n_slots=12, n_bins=10, n_classes=3)
    want = np.asarray(jref.frontier_histogram_ref(x, y, w, slot, **kw))
    for pins in (dict(n_live_slots=2), dict(n_live_slots=5, block_k=2)):
        plan = autotune.plan_histogram(n_cases=2_000, n_attrs=5, **kw,
                                       **pins)
        assert plan.mode == "shared"
        got = emulate_histogram(*map(torch.as_tensor, (x, y, w, slot)),
                                plan=plan, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_emulation_drops_out_of_contract_values():
    x = np.array([[0, 5], [9, 1], [-1, 2]], np.int32)    # bin 9 > B = 4
    y = np.array([0, 1, 3], np.int32)                    # class 3 >= C = 2
    w = np.ones(3, np.float32)
    slot = np.array([0, 0, 1], np.int32)
    kw = dict(n_slots=2, n_bins=4, n_classes=2)
    for block_k in (0, 1, 2):
        plan = autotune.plan_histogram(n_cases=3, n_attrs=2, block_k=block_k,
                                       **kw)
        got = emulate_histogram(*map(torch.as_tensor, (x, y, w, slot)),
                                plan=plan, **kw)
        want = torch.zeros(2, 2, 5, 2)
        want[0, 0, 0, 0] = 1                              # case 0, attr 0
        want[0, 1, 1, 1] = 1                              # case 1, attr 1
        assert torch.equal(got, want), block_k


# --------------------------------------------------------------------------
# split gain: the warp's decomposition, emulated
# --------------------------------------------------------------------------

def _xlogx(p):
    return torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)),
                       0.0)


def _winfo(t):
    """weighted_info over the last axis, class sums in ascending c."""
    w = t[..., 0]
    s = _xlogx(t[..., 0])
    for c in range(1, t.shape[-1]):
        w = w + t[..., c]
        s = s + _xlogx(t[..., c])
    return torch.clamp_min(_xlogx(w) - s, 0.0), w


def _butterfly_sum(v):
    """__shfl_xor_sync sum over the lane axis (last): every lane's total."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v


def emulate_split_gain(hist, total_w, attr_is_cont, n_bins, *, min_objs,
                       criterion, plan):
    """What csrc/split_gain.cu computes for every (k, a) row."""
    k_dim, a_dim, b_dim, c_dim = hist.shape
    seg = plan.seg
    rows = hist.reshape(-1, b_dim, c_dim).float()
    r_dim = rows.shape[0]
    pad = torch.zeros(r_dim, 32 * seg - b_dim, c_dim)
    # (R, C, 32 lanes, seg): bin b at lane b // seg, position b % seg
    planes = torch.cat([rows, pad], 1).permute(0, 2, 1).reshape(
        r_dim, c_dim, 32, seg)
    n_own = torch.clamp(b_dim - torch.arange(32) * seg, 0, seg)
    own = torch.arange(seg)[None, :] < n_own[:, None]            # (32, seg)
    lane = torch.arange(32)
    tw = total_w.float().repeat_interleave(a_dim)
    tw_safe = torch.where(tw > EPS_W, tw, 1.0)
    nb = n_bins.repeat(k_dim).long()
    cont = attr_is_cont.repeat(k_dim)
    bins = (lane[:, None] * seg + torch.arange(seg)[None, :])    # (32, seg)

    # continuous: per class, segment sums, shuffle scan, serial scan
    s = torch.zeros(r_dim, c_dim, 32)
    for i in range(seg):
        s = s + planes[..., i]
    incl = s
    for o in (1, 2, 4, 8, 16):
        up = torch.cat([torch.zeros(r_dim, c_dim, o), incl[..., :-o]], -1)
        incl = torch.where(lane >= o, incl + up, incl)
    run = torch.cat([torch.zeros(r_dim, c_dim, 1), incl[..., :-1]], -1)
    left = torch.empty_like(planes)
    for i in range(seg):
        run = run + planes[..., i]
        left[..., i] = run
    left = left.permute(0, 2, 3, 1)                              # (R,32,seg,C)
    kb = b_dim - 1
    known = left[:, kb // seg, kb % seg, :]                      # (R, C)
    info_parent, w_known = _winfo(known)
    safe_w = torch.where(w_known > EPS_W, w_known, 1.0)
    f = w_known / tw_safe
    il, wl = _winfo(left)
    ir, wr = _winfo(known[:, None, None, :] - left)
    gain = (info_parent[:, None, None] - (il + ir)) / safe_w[:, None, None]
    gain = f[:, None, None] * gain
    if criterion == "gain_ratio":
        w2 = wl + wr
        safe2 = torch.where(w2 > EPS_W, w2, 1.0)
        ent = torch.log2(safe2) - (_xlogx(wl) + _xlogx(wr)) / safe2
        denom = torch.where(w2 > EPS_W, torch.clamp_min(ent, 0.0), 0.0)
        gain = torch.where(denom > EPS_W, gain / denom, 0.0)
    valid = ((bins[None] < nb[:, None, None] - 1) & (wl >= min_objs)
             & (wr >= min_objs))
    # the kernels skip an empty bin b > 0: the register kernel one whose
    # counts are all zero, the shared-memory one a prefix equal to bin b-1's
    flat = left.reshape(r_dim, 32 * seg, c_dim)[:, :b_dim]
    empty = torch.zeros(r_dim, 32 * seg, dtype=torch.bool)
    if plan.regs:
        empty[:, 1:b_dim] = (rows[:, 1:] == 0).all(-1)
    else:
        empty[:, 1:b_dim] = (flat[:, 1:] == flat[:, :-1]).all(-1)
    cand = own & ~empty.view(r_dim, 32, seg)                     # (R,32,seg)
    score = torch.where(valid & cand, gain, float("-inf"))
    # each lane's serial take_better, then the butterfly argmax
    best_s = torch.full((r_dim, 32), float("-inf"))
    best_b = torch.full((r_dim, 32), 2 ** 31 - 1)
    for i in range(seg):
        s2, b2 = score[..., i], bins[:, i].expand(r_dim, 32)
        take = cand[..., i] & ((s2 > best_s)
                               | ((s2 == best_s) & (b2 < best_b)))
        best_s = torch.where(take, s2, best_s)
        best_b = torch.where(take, b2, best_b)
    for o in (16, 8, 4, 2, 1):
        s2, b2 = best_s[:, lane ^ o], best_b[:, lane ^ o]
        take = (s2 > best_s) | ((s2 == best_s) & (b2 < best_b))
        best_s = torch.where(take, s2, best_s)
        best_b = torch.where(take, b2, best_b)
    cont_score, cont_bin = best_s[:, 0], best_b[:, 0]

    # discrete: per-lane serial sums over own bins, then butterfly sums
    lft = planes.permute(0, 2, 3, 1)                             # (R,32,seg,C)
    structural = own & (bins[None] < nb[:, None, None])
    ib, wb = _winfo(lft)
    ib = torch.where(structural, ib, 0.0)
    wb = torch.where(structural, wb, 0.0)
    terms = [ib, wb, _xlogx(wb), torch.where(own & (wb >= min_objs), 1.0,
                                             0.0)]
    sums = []
    for t in terms:
        acc = torch.zeros(r_dim, 32)
        for i in range(seg):
            acc = acc + t[..., i]
        sums.append(_butterfly_sum(acc)[:, 0])
    child_info, w_bins, w_bins_xlogx, branches = sums
    w_par = torch.zeros(r_dim)
    s_par = torch.zeros(r_dim)
    for c in range(c_dim):
        acc = torch.zeros(r_dim, 32)
        for i in range(seg):
            acc = acc + torch.where(structural[..., i], lft[..., i, c], 0.0)
        v = _butterfly_sum(acc)[:, 0]
        w_par = w_par + v
        s_par = s_par + _xlogx(v)
    info_par = torch.clamp_min(_xlogx(w_par) - s_par, 0.0)
    safe_p = torch.where(w_par > EPS_W, w_par, 1.0)
    dgain = (info_par - child_info) / safe_p
    dgain = (w_par / tw_safe) * dgain
    dgain = torch.where(w_par > EPS_W, torch.clamp_min(dgain, 0.0), 0.0)
    if criterion == "gain_ratio":
        safe_b = torch.where(w_bins > EPS_W, w_bins, 1.0)
        ent = torch.log2(safe_b) - w_bins_xlogx / safe_b
        denom = torch.where(w_bins > EPS_W, torch.clamp_min(ent, 0.0), 0.0)
        dgain = torch.where(denom > EPS_W, dgain / denom, 0.0)
    disc_score = torch.where(branches >= 2, dgain, float("-inf"))
    score = torch.where(cont, cont_score, disc_score)
    split_bin = torch.where(cont, cont_bin, -1).to(torch.int32)
    return score.view(k_dim, a_dim), split_bin.view(k_dim, a_dim)


def _gain_inputs(rng, k, a, b, c):
    hist = (rng.integers(0, 6, (k, a, b, c))
            * (rng.random((k, a, b, c)) < 0.7)).astype(np.float32)
    hist[-1] = 0                                   # a padded slot
    tw = (hist.sum((1, 2, 3)) / a + rng.integers(0, 4, k)).astype(np.float32)
    tw[-1] = 0
    cont = rng.random(a) < 0.5
    cont[:2] = (True, False)
    nb = rng.integers(1, b + 1, a).astype(np.int32)
    return hist, tw, cont, nb


@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
@pytest.mark.parametrize("k,a,b,c", [(4, 3, 8, 2), (10, 5, 13, 4),
                                     (16, 6, 13, 23), (7, 5, 300, 3),
                                     (24, 9, 256, 2), (3, 4, 1, 2),
                                     (2, 4, 33, 2), (6, 40, 128, 2),
                                     (3, 5, 100, 2), (2, 4, 257, 2)])
def test_split_gain_emulation_matches_jax(k, a, b, c, criterion):
    rng = np.random.default_rng(k * a + b)
    hist, tw, cont, nb = _gain_inputs(rng, k, a, b, c)
    plan = autotune.plan_split_gain(n_bins=b, n_classes=c)
    th = [torch.as_tensor(v) for v in (hist, tw, cont, nb)]
    # to the JAX scorer: the port's scorer's own tolerances against it
    # (tests/test_torch_kernels_ref.py); to the port's scorer: the kernel's
    jax_tol = 1e-5 if criterion == "gain" else 1e-4
    for min_objs in (2.0, 0.0):
        kw = dict(min_objs=min_objs, criterion=criterion)
        s_e, b_e = emulate_split_gain(*th, plan=plan, **kw)
        s_j, b_j = jentropy.gains_from_histogram(
            jnp.asarray(hist), total_w=jnp.asarray(tw),
            attr_is_cont=jnp.asarray(cont), n_bins=jnp.asarray(nb), **kw)
        s_j, b_j = np.asarray(s_j), np.asarray(b_j)
        s_t, b_t = entropy.gains_from_histogram(
            th[0], total_w=th[1], attr_is_cont=th[2], n_bins=th[3], **kw)
        np.testing.assert_array_equal(b_e.numpy(), b_j)
        np.testing.assert_array_equal(b_e.numpy(), b_t.numpy())
        fin = np.isfinite(s_j)
        np.testing.assert_array_equal(np.isfinite(s_e.numpy()), fin)
        assert np.all(s_e.numpy()[~fin] == s_j[~fin])     # the -inf's
        err = np.abs(s_e.numpy()[fin] - s_j[fin])
        assert np.all(err <= jax_tol * (1 + np.abs(s_j[fin])))
        s_t = s_t.numpy()
        err = np.abs(s_e.numpy()[fin] - s_t[fin])
        assert np.all(err <= 1e-5 * (1 + np.abs(s_t[fin])))
        # integral counts: the scan is exact and each continuous bin is
        # scored as the port's scorer scores it
        cont_rows = np.broadcast_to(cont, s_e.shape)
        np.testing.assert_array_equal(s_e.numpy()[cont_rows],
                                      s_t[cont_rows])


def test_split_gain_emulation_ties_take_the_lower_bin():
    """Equal scores in two lanes' segments: the butterfly keeps the lower
    bin, as torch.argmax's first maximum does."""
    b, c = 64, 2
    hist = np.zeros((1, 1, b, c), np.float32)
    hist[0, 0, [3, 40], 0] = 5                      # two mirror-image cuts
    hist[0, 0, [20, 60], 1] = 5
    tw = hist.sum((1, 2, 3))
    cont, nb = np.array([True]), np.array([b], np.int32)
    plan = autotune.plan_split_gain(n_bins=b, n_classes=c)
    s_e, b_e = emulate_split_gain(
        *[torch.as_tensor(v) for v in (hist, tw, cont, nb)], plan=plan,
        min_objs=2.0, criterion="gain")
    s_t, b_t = entropy.gains_from_histogram(
        torch.as_tensor(hist), total_w=torch.as_tensor(tw),
        attr_is_cont=torch.as_tensor(cont), n_bins=torch.as_tensor(nb))
    assert int(b_e) == int(b_t) and float(s_e) == float(s_t)
