"""Launch plans of the CUDA kernels, pure functions of the shapes.

The TPU planner sized its tiles to a VMEM budget; on the H100 the scarce
resources are shared memory per block (at most 227 KB, above 48 KB only with
the dynamic attribute) and the blocks in flight on 132 SMs:

  histogram:  a block stages tiles of block_t cases (their x words, one
              output offset and one weight a case) in shared memory and adds
              each (case, attribute) either straight into the output
              ("direct") or into a window of block_k slot rows privatised
              in shared memory ("shared"); see plan_histogram.
  split_gain: one warp per (slot, attribute) row, `warps` rows a block;
              with two classes and B <= 256 each lane holds its segment of
              bins in registers, otherwise the tile sits in shared memory
              as class planes of 32 lane segments.
  tree_infer: one thread per (tree, case), a block block_n consecutive
              cases of one tree, no shared memory; see plan_infer_blocks.

``GrowConfig.block_t`` pins the histogram's cases per tile, ``block_k`` its
slots per shared window (0: the direct plan), ``block_b`` the split-gain
block's threads (32 per row); ``block_n`` pins the traversal's cases (threads)
a block.  None means the choices below.
"""

from __future__ import annotations

import dataclasses

# Shared memory one block may use on Hopper (the opt-in maximum), and what
# an SM holds for all its blocks (each block also costs 1 KB of it).
SMEM_MAX = 232_448
SMEM_PER_SM = 233_472
H100_SMS = 132
# Histogram: threads a block; its two tiles (block_t cases each, one copied
# in while the other is counted) kept under HIST_TILE_BYTES; a shared plan's
# tiles cut so that tiles and window stay under HIST_SMEM_BUDGET, two
# blocks of 512 threads an SM, where the window leaves room.
HIST_THREADS = 512
HIST_TILE = 512
HIST_TILE_BYTES = 48 * 1024
HIST_SMEM_BUDGET = 112 * 1024
# Cases one block may count: its shared window sums the integral parts of
# weights below 256 as int32, which holds 2^23 of them a cell.
HIST_MAX_BLOCK_CASES = 1 << 23
# The shared plan pays for itself where a superstep puts at least this many
# cases on each (live slot, bin, class) cell of an attribute; below it the
# direct plan needs no flush.  The direct plan aggregates the lanes of a
# warp that add to one cell: a node's cases crowd into few cells (one
# class, a narrow range of each attribute it was split on), and their
# device adds serialise on those cells.
HIST_DENSE_CASES_PER_CELL = 8
# Blocks a launch: the direct plan up to a few waves (a block has no fixed
# cost), the shared plan one wave (each block flushes its window).
HIST_DIRECT_WAVES = 4
HIST_SHARED_WAVES = 1
# Split gain: rows (warps) a block of the shared-memory kernel and of the
# register kernel (small blocks even out the SMs' share of a launch); the
# bins a lane holds in registers in the two-class kernel's instantiations.
GAIN_WARPS = 8
GAIN_REGS_WARPS = 2
GAIN_REGS = (1, 2, 4, 8)
# Forest traversal: the widest block (cases of one tree), taken while the
# grid still puts a block on every SM; a grid's y extent (trees; blocks
# walk the trees beyond it in turn).
INFER_THREADS = 1024
GRID_Y_MAX = 65_535


@dataclasses.dataclass(frozen=True)
class HistPlan:
    mode: str           # "direct" (warp-aggregated) or "shared"
    live: int           # slots the windows cover (higher: device adds)
    block_t: int        # cases a tile
    block_k: int        # slots a shared window (0: direct)
    windows: int        # grid y: shared windows over the live slots
    blocks: int         # grid x: blocks a window
    threads: int
    smem: int           # dynamic shared memory a block, bytes


@dataclasses.dataclass(frozen=True)
class GainPlan:
    warps: int          # (slot, attribute) rows a block, one warp each
    regs: bool          # the register kernel (two classes, seg in GAIN_REGS)
    seg: int            # consecutive bins a lane
    seg_pad: int        # seg rounded up to odd: a lane's stride in a plane
    smem: int           # dynamic shared memory a block, bytes (0: regs)

    @property
    def threads(self) -> int:
        return 32 * self.warps


@dataclasses.dataclass(frozen=True)
class InferPlan:
    mode: str           # "wide" (INFER_THREADS cases a block) or "spread"
                        # (fewer, so that the blocks cover the SMs)
    threads: int        # cases a block, one thread each
    case_blocks: int    # grid x: blocks a tree
    tree_blocks: int    # grid y: trees at once, at most GRID_Y_MAX

    @property
    def blocks(self) -> int:
        return self.case_blocks * self.tree_blocks


def _blocks_per_sm(threads: int, smem: int) -> int:
    return max(1, min(2048 // threads, SMEM_PER_SM // (smem + 1024)))


def hist_case_bytes(n_attrs: int) -> int:
    """Shared memory a case takes in the histogram's two tiles: its x row
    at an odd stride, its slot (then offset code), class and weight."""
    return 2 * 4 * ((n_attrs | 1) + 3)


def plan_histogram(*, n_cases: int, n_slots: int, n_bins: int,
                   n_classes: int, n_attrs: int,
                   n_live_slots: int | None = None,
                   block_t: int | None = None,
                   block_k: int | None = None) -> HistPlan:
    """The histogram's launch for ``n_cases`` cases whose slots lie below
    ``n_live_slots`` (default ``n_slots``; a case of a higher slot is still
    counted, by device adds).  Pinned sizes win.

    Shared when the superstep is dense (at least
    HIST_DENSE_CASES_PER_CELL cases per (live slot, bin, class) cell) and
    one window of all live slots fits a block beside its tiles; direct
    otherwise.
    """
    cells = (n_bins + 1) * n_classes
    row_bytes = 4 * n_attrs * cells
    if 2 * n_slots * n_attrs * cells >= 2 ** 31:
        raise ValueError(f"a (K, A, B+1, C) = ({n_slots}, {n_attrs}, "
                         f"{n_bins + 1}, {n_classes}) histogram is too large "
                         f"for the kernel's 31-bit offsets")
    live = n_slots if n_live_slots is None else n_live_slots
    live = max(1, min(int(live), n_slots))
    case_bytes = hist_case_bytes(n_attrs)
    pinned_t = block_t is not None
    if block_t is None:
        block_t = min(HIST_TILE,
                      max(32, HIST_TILE_BYTES // case_bytes // 32 * 32))
    if block_t < 1:
        raise ValueError(f"block_t must be >= 1, got {block_t}")
    tile_bytes = block_t * case_bytes
    density = n_cases / (live * cells)
    if block_k is None:
        dense = density >= HIST_DENSE_CASES_PER_CELL
        fits = tile_bytes + live * row_bytes <= SMEM_MAX
        block_k = live if dense and fits else 0
    if block_k < 0:
        raise ValueError(f"block_k must be >= 0, got {block_k}")
    block_k = min(block_k, live)
    if block_k:
        window = block_k * row_bytes               # int32 counts
        if not pinned_t and tile_bytes + window > HIST_SMEM_BUDGET:
            # smaller tiles, if that keeps two blocks on an SM
            fit = (HIST_SMEM_BUDGET - window) // case_bytes // 32 * 32
            if fit >= 32:
                block_t, tile_bytes = fit, fit * case_bytes
        smem = tile_bytes + window
        windows = -(-live // block_k)
        waves = HIST_SHARED_WAVES
    else:
        smem, windows, waves = tile_bytes, 1, HIST_DIRECT_WAVES
    if smem > SMEM_MAX:
        raise ValueError(
            f"block_t={block_t}, block_k={block_k} need {smem} B of shared "
            f"memory; a block has {SMEM_MAX} B")
    per_sm = _blocks_per_sm(HIST_THREADS, smem)
    tiles = -(-max(1, n_cases) // block_t)
    blocks = max(1, min(tiles, waves * H100_SMS * per_sm // windows),
                 -(-n_cases // HIST_MAX_BLOCK_CASES))
    return HistPlan(mode="shared" if block_k else "direct", live=live,
                    block_t=int(block_t), block_k=int(block_k),
                    windows=int(windows), blocks=int(blocks),
                    threads=HIST_THREADS, smem=int(smem))


def plan_split_gain(*, n_bins: int, n_classes: int,
                    block_b: int | None = None) -> GainPlan:
    """Split-gain launch (a pinned ``block_b``, threads a block, wins).

    Two classes and at most 32 * 8 bins: the register kernel, each lane's
    bins in registers (seg the next of GAIN_REGS at or above B / 32), no
    shared memory, GAIN_REGS_WARPS rows a block.  Otherwise the
    shared-memory kernel: GAIN_WARPS rows a block, fewer where their tiles
    outgrow SMEM_MAX.
    """
    seg = -(-n_bins // 32)
    if block_b is not None and (block_b % 32 or not 32 <= block_b <= 1024):
        raise ValueError(f"split-gain threads must be a multiple of 32 in "
                         f"[32, 1024], got {block_b}")
    regs = [s for s in GAIN_REGS if s >= seg]
    if n_classes == 2 and regs:
        warps = GAIN_REGS_WARPS if block_b is None else block_b // 32
        return GainPlan(warps=warps, regs=True, seg=regs[0], seg_pad=0,
                        smem=0)
    seg_pad = seg | 1
    row_bytes = 4 * n_classes * 32 * seg_pad
    if row_bytes > SMEM_MAX:
        raise ValueError(f"a (B, C) = ({n_bins}, {n_classes}) tile needs "
                         f"{row_bytes} B of shared memory; a block has "
                         f"{SMEM_MAX}")
    if block_b is None:
        warps = min(GAIN_WARPS, SMEM_MAX // row_bytes)
    else:
        warps = block_b // 32
    if warps * row_bytes > SMEM_MAX:
        raise ValueError(f"{warps} rows of a (B, C) = ({n_bins}, "
                         f"{n_classes}) tile need {warps * row_bytes} B of "
                         f"shared memory; a block has {SMEM_MAX}")
    return GainPlan(warps=int(warps), regs=False, seg=int(seg),
                    seg_pad=int(seg_pad), smem=int(warps * row_bytes))


def plan_infer_blocks(*, n_cases: int, n_trees: int,
                      block_n: int | None = None) -> InferPlan:
    """Forest-traversal launch for ``n_trees`` trees over ``n_cases`` cases
    (a pinned ``block_n``, the cases a block, wins): the widest power-of-two
    block up to INFER_THREADS, no wider than the cases in whole warps, whose
    grid still has at least H100_SMS blocks; 32 where none has.

    The TPU planner sized a case tile to hold the one-hot expansion and the
    table in VMEM; here a thread walks one case and reads the table through
    the read-only cache, so only the block is left to choose: wide blocks
    where the walks fill the card many times over (a block's lanes walk
    neighbouring cases of one tree), and blocks spread over the SMs where a
    small batch leaves them idle.
    """
    n = max(1, int(n_cases))
    t_dim = max(1, int(n_trees))
    if block_n is None:
        block_n = 32
        while (block_n < INFER_THREADS and 2 * block_n <= 32 * -(-n // 32)
               and t_dim * -(-n // (2 * block_n)) >= H100_SMS):
            block_n *= 2
    if block_n % 32 or not 32 <= block_n <= 1024:
        raise ValueError(f"traversal threads must be a multiple of 32 in "
                         f"[32, 1024], got {block_n}")
    case_blocks = -(-n // block_n)
    if case_blocks >= 2 ** 31:
        raise ValueError(f"{case_blocks} blocks of {block_n} cases pass the "
                         f"2^31 - 1 of a grid's x extent")
    return InferPlan(mode="wide" if block_n == INFER_THREADS else "spread",
                     threads=int(block_n), case_blocks=int(case_blocks),
                     tree_blocks=min(t_dim, GRID_Y_MAX))
