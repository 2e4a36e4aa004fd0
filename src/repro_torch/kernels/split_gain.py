"""Wrapper of the CUDA fused split-gain kernel (``csrc/split_gain.cu``).

Replaces the JAX package's Pallas ``split_gain``: from the (K, A, B, C)
frontier histogram, ``score`` f32 (K, A) (-inf = no valid split) and
``split_bin`` int32 (K, A) (-1 for discrete attributes).  CUDA tensors only;
the plain version is :func:`repro_torch.kernels.ref.split_gain_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, autotune

# Launches of the kernel in this process (the main path's proof of use).
LAUNCHES = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P, _P, _P,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
CRITERIA = ("gain", "gain_ratio")


def _lib() -> ctypes.CDLL:
    lib = _build.library("split_gain")
    lib.split_gain_launch.argtypes = _ARGTYPES
    lib.split_gain_launch.restype = ctypes.c_int
    lib.split_gain_error.argtypes = [ctypes.c_int]
    lib.split_gain_error.restype = ctypes.c_char_p
    return lib


def split_gain(hist: torch.Tensor, total_w: torch.Tensor,
               attr_is_cont: torch.Tensor, n_bins: torch.Tensor, *,
               min_objs: float = 2.0, criterion: str = "gain",
               block_b: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(score, split_bin)`` per (slot, attribute) of ``hist`` f32
    (K, A, B, C), ``total_w`` f32 (K,), ``attr_is_cont`` bool (A,) and
    ``n_bins`` int32 (A,).

    ``hist`` may be a view whose last two axes are contiguous, such as the
    first B bins of the histogram kernel's (K, A, B+1, C) output.
    """
    global LAUNCHES
    dev = hist.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA split gain takes CUDA tensors, got {dev}")
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion: {criterion!r}")
    if hist.ndim != 4 or hist.dtype != torch.float32:
        raise TypeError(f"hist must be f32 (K, A, B, C), got {hist.dtype} "
                        f"{tuple(hist.shape)}")
    k, a_dim, b_dim, c_dim = hist.shape
    if hist.stride(3) != 1 or hist.stride(2) != c_dim:
        raise ValueError("hist must have contiguous (B, C) rows")
    for t, name, dtype, shape in ((total_w, "total_w", torch.float32, (k,)),
                                  (attr_is_cont, "attr_is_cont", torch.bool,
                                   (a_dim,)),
                                  (n_bins, "n_bins", torch.int32, (a_dim,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dtype} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    score = torch.empty((k, a_dim), dtype=torch.float32, device=dev)
    split_bin = torch.empty((k, a_dim), dtype=torch.int32, device=dev)
    if k == 0 or a_dim == 0:
        return score, split_bin
    if b_dim == 0 or c_dim == 0:
        raise ValueError(f"hist needs B >= 1 and C >= 1, got {b_dim}, {c_dim}")
    plan = autotune.plan_split_gain(n_bins=b_dim, n_classes=c_dim,
                                    block_b=block_b)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.split_gain_launch(
            hist.data_ptr(), hist.stride(0), hist.stride(1),
            total_w.data_ptr(), attr_is_cont.data_ptr(), n_bins.data_ptr(),
            score.data_ptr(), split_bin.data_ptr(), k, a_dim, b_dim, c_dim,
            float(min_objs), int(criterion == "gain_ratio"), plan.threads,
            stream)
    if err:
        raise RuntimeError("split_gain launch failed: "
                           + lib.split_gain_error(err).decode())
    LAUNCHES += 1
    return score, split_bin
