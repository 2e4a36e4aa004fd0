"""The yardstick's peaks and work formulas, frozen for the benchmark.

Copied from ``src/repro_torch/launch/roofline.py`` at commit
fe76ba3c169015bc8474eaf345bd872003045a00 (the H100 peaks, ``bound_ms``,
``histogram_bytes`` / ``histogram_ops`` and ``split_gain_bytes`` /
``split_gain_ops``).  The benchmark never imports the program's copy: a
change there moves no reading here.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA data sheet, dense
rates): 67 TFLOP/s f32 on the CUDA cores, which every operation of a tree
build uses, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time of work that moves ``n_bytes`` and does ``n_ops``
    f32 operations on one H100: the larger of the two times."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def histogram_bytes(n: int, a: int, cells: int) -> int:
    """Each case row (A int32 bins, label, weight, slot) read once, each of
    ``cells`` output cells written once."""
    return n * (4 * a + 12) + 4 * cells


def histogram_ops(n: int, a: int) -> int:
    """One add per (case, attribute)."""
    return n * a


def split_gain_bytes(k: int, a: int, b: int, c: int) -> int:
    """The (K, A, B, C) f32 histogram, the K totals, the A flags and bin
    counts read once; the (K, A) score and bin written once."""
    return k * a * b * c * 4 + k * 4 + a * 5 + k * a * 8


def split_gain_ops(k: int, a: int, b: int, c: int) -> int:
    """The prefix scan, the entropies and the argmax: 6C + 20 a bin."""
    return k * a * b * (6 * c + 20)
