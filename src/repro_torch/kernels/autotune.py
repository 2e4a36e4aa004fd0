"""Tile sizes of the CUDA splitAtt kernels, from the problem's shape.

The TPU planner sized its tiles to a VMEM budget; on the H100 the scarce
resource is shared memory per block (at most 227 KB, above 48 KB only with
the dynamic attribute) and the number of blocks in flight:

  histogram:  each block privatises a block_k x (B+1) x C f32
              sub-histogram in shared memory; block_t cases per block.
  split_gain: one block per (slot, attribute) holds its (B, C) tile twice
              (scan ping-pong); threads per block cover the bins.
  tree_infer: one thread per (tree, case); no shared memory.

``GrowConfig.block_t`` / ``block_k`` / ``block_b`` pin the splitAtt sizes;
``block_n`` pins the traversal's.  None means the heuristics below.
"""

from __future__ import annotations

import dataclasses

# Shared memory one block may use on Hopper (the opt-in maximum).
SMEM_MAX = 232_448
# Histogram sub-histogram budget: half the SM's shared memory, so two blocks
# of 512 threads share an SM.
HIST_SMEM_BUDGET = 112 * 1024
HIST_THREADS = 512
# Forest traversal: cases (threads) per block.
INFER_THREADS = 256
# Blocks per launch to aim for: a few waves over the H100's 132 SMs.
H100_SMS = 132
TARGET_BLOCKS = 4 * H100_SMS


def _pow2_ceil(x: int) -> int:
    return 1 << (max(1, int(x)) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class HistPlan:
    block_t: int        # cases per block
    block_k: int        # slots per block (sub-histogram rows)
    threads: int


@dataclasses.dataclass(frozen=True)
class GainPlan:
    threads: int        # bins scored per pass of a block


@dataclasses.dataclass(frozen=True)
class InferPlan:
    threads: int        # cases per block, one thread each


def plan_histogram(*, n_cases: int, n_slots: int, n_bins: int,
                   n_classes: int, n_attrs: int,
                   block_t: int | None = None,
                   block_k: int | None = None) -> HistPlan:
    """Histogram tiles for ``n_cases`` live cases (pinned sizes win)."""
    slot_bytes = 4 * (n_bins + 1) * n_classes
    if slot_bytes > SMEM_MAX:
        raise ValueError(
            f"one slot's (B+1) x C = {n_bins + 1} x {n_classes} f32 "
            f"sub-histogram needs {slot_bytes} B of shared memory; a block "
            f"has {SMEM_MAX} B")
    bk = block_k or max(1, min(n_slots, HIST_SMEM_BUDGET // slot_bytes))
    if bk * slot_bytes > SMEM_MAX:
        raise ValueError(f"block_k={bk} needs {bk * slot_bytes} B of shared "
                         f"memory; a block has {SMEM_MAX} B")
    if block_t is None:
        # Enough chunks that the blocks of one slot window fill the card:
        # at the root superstep every case sits in slot 0, so only the
        # first slot window has work.
        chunks = max(1, -(-TARGET_BLOCKS // max(1, n_attrs)))
        block_t = max(HIST_THREADS, -(-max(1, n_cases) // chunks))
    return HistPlan(block_t=int(block_t), block_k=int(bk),
                    threads=HIST_THREADS)


def plan_split_gain(*, n_bins: int, n_classes: int,
                    block_b: int | None = None) -> GainPlan:
    """Split-gain block size (pinned ``block_b`` wins)."""
    smem = 4 * (2 * n_bins * n_classes + 64)
    if smem > SMEM_MAX:
        raise ValueError(f"a (B, C) = ({n_bins}, {n_classes}) tile needs "
                         f"{smem} B of shared memory; a block has {SMEM_MAX}")
    threads = block_b or min(256, max(32, _pow2_ceil(n_bins)))
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"split-gain threads must be a multiple of 32 in "
                         f"[32, 1024], got {threads}")
    return GainPlan(threads=int(threads))


def plan_infer_blocks(*, n_cases: int,
                      block_n: int | None = None) -> InferPlan:
    """Forest-traversal block for ``n_cases`` cases (pinned ``block_n``
    wins): INFER_THREADS, no wider than the cases, in whole warps.

    The TPU planner sized a case tile to hold the one-hot expansion and the
    table in VMEM; here a thread holds one case and reads the table through
    the read-only cache, so only the block width is left to choose.
    """
    if block_n is None:
        block_n = min(INFER_THREADS, 32 * -(-max(1, n_cases) // 32))
    if block_n % 32 or not 32 <= block_n <= 1024:
        raise ValueError(f"traversal threads must be a multiple of 32 in "
                         f"[32, 1024], got {block_n}")
    return InferPlan(threads=int(block_n))
