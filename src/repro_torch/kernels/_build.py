"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, on its own,
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout; the
hash covers the source, the headers of ``csrc/`` (``*.cuh``) and the flags,
so an edited source or header builds anew and an unchanged one is reused.
Nothing includes PyTorch's headers, so a build takes seconds.  The kernels
are built at first use, never at import, and once a process: a lock makes
threads that reach a kernel together wait for one build and one load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

KERNELS = ("histogram", "split_gain", "split_post", "tree_infer",
           "flash_attention", "flash_attention_bwd")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")
# -fmad=false: no fused multiply-add contraction, so the split-gain kernel
# rounds every product and sum as its torch specification does (and the
# histogram, splitPost and traversal kernels, built so since they were
# written).  The
# flash kernels (forward and backward) are chains of dot products: they keep
# the contraction, which halves their instruction count, and are held to a
# tolerance.
FMA_KERNELS = ("flash_attention", "flash_attention_bwd")


def nvcc_flags(name: str) -> tuple[str, ...]:
    if name in FMA_KERNELS:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
    return NVCC_FLAGS

_LIBS: dict[str, ctypes.CDLL] = {}
# Held by build() and by library()'s first load of a kernel.
_LOCK = threading.RLock()


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every missing library of ``names`` with one nvcc each, all
    started together.  Returns nvcc's output per built kernel (ptxas
    register and shared-memory report); raises with it on a failure."""
    with _LOCK:
        return _compile(names)


def _compile(names) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *nvcc_flags(name), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
