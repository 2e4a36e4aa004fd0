"""Wrapper of the CUDA frontier-histogram kernel (``csrc/histogram.cu``).

Replaces the JAX package's Pallas ``frontier_histogram``: the same inputs
and the same ``(K, A, B+1, C)`` f32 output, with unknown bins (-1) counted
in bin B and cases of slot -1 dropped.  CUDA tensors only; the plain version
is :func:`repro_torch.kernels.ref.frontier_histogram_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, autotune

# Launches of the kernel in this process (the main path's proof of use).
LAUNCHES = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, _P]


def _lib() -> ctypes.CDLL:
    lib = _build.library("histogram")
    lib.frontier_histogram_launch.argtypes = _ARGTYPES
    lib.frontier_histogram_launch.restype = ctypes.c_int
    lib.frontier_histogram_error.argtypes = [ctypes.c_int]
    lib.frontier_histogram_error.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def frontier_histogram(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       slot: torch.Tensor, *, n_slots: int, n_bins: int,
                       n_classes: int, block_t: int | None = None,
                       block_k: int | None = None) -> torch.Tensor:
    """(K, A, B+1, C) weighted counts of ``x`` int32 (N, A) bins, ``y``
    int32 (N,) classes, ``w`` f32 (N,) weights, ``slot`` int32 (N,)."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA histogram takes CUDA tensors, got {dev}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, A), got shape {tuple(x.shape)}")
    n, a_dim = x.shape
    _check(x, "x", torch.int32, (n, a_dim), dev)
    _check(y, "y", torch.int32, (n,), dev)
    _check(w, "w", torch.float32, (n,), dev)
    _check(slot, "slot", torch.int32, (n,), dev)
    out = torch.zeros((n_slots, a_dim, n_bins + 1, n_classes),
                      dtype=torch.float32, device=dev)
    if n == 0 or a_dim == 0 or n_slots == 0 or n_classes == 0:
        return out
    plan = autotune.plan_histogram(
        n_cases=n, n_slots=n_slots, n_bins=n_bins, n_classes=n_classes,
        n_attrs=a_dim, block_t=block_t, block_k=block_k)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.frontier_histogram_launch(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), slot.data_ptr(),
            out.data_ptr(), n, a_dim, n_slots, n_bins, n_classes,
            plan.block_k, plan.block_t, plan.threads, stream)
    if err:
        raise RuntimeError("frontier_histogram launch failed: "
                           + lib.frontier_histogram_error(err).decode())
    LAUNCHES += 1
    return out
