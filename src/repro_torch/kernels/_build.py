"""Build the CUDA kernels of ``csrc/`` with nvcc, load them with ctypes and
launch them: the one module of the port that touches ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, on its own,
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout; the
hash covers the source, the headers of ``csrc/`` (``*.cuh``) and the flags,
so an edited source or header builds anew and an unchanged one is reused.
Nothing includes PyTorch's headers, so a build takes seconds.  The kernels
are built at first use, never at import, and once a process: a lock makes
threads that reach a kernel together wait for one build and one load.

Each wrapper declares its library's C interface once, as data (a
:class:`Library`), and launches through :func:`launch`: it binds the entry
points' signatures at the library's first use, launches on the current
stream of the tensors' device, raises on an error code with the library's
own text, and counts the launch in the wrapper's counters.  :func:`check`
is the wrappers' one test of a tensor before its pointer is passed.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path

import torch

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
# A library's entry points and error function with their signatures set.
_BOUND: dict[str, dict] = {}
# Held by build(), by library()'s first load of a kernel and by the first
# binding of its signatures.
_LOCK = threading.RLock()
# Keeps the wrappers' launch counts exact under launches from several
# threads (the farm's workers).
_COUNT_LOCK = threading.Lock()
# A signature's codes, each after an optional repeat count: p void *,
# i int, q long long, f float, Q uint64 *, I uint32 *.
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "f": ctypes.c_float, "Q": ctypes.POINTER(ctypes.c_uint64),
           "I": ctypes.POINTER(ctypes.c_uint32)}


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


@dataclass(frozen=True)
class Library:
    """The C interface of ``csrc/<name>.cu`` as its wrapper declares it.

    ``entries`` maps each entry point to the codes of its arguments
    (``_CTYPES``; ``"5p q 11i"``) before the stream, which :func:`launch`
    passes last; an entry point returns 0 or an error code that ``error``
    (int -> C string) describes.  A launch adds 1 to the int ``total`` of
    the module ``counts`` and, with ``by``, to the launch's label in that
    module's dict ``by``.  ``opt_in``: the entry points set their kernels'
    shared-memory opt-in, a state of the process, so this library's
    launches run one at a time and none runs under another thread's lower
    opt-in."""
    name: str
    error: str
    entries: dict[str, str]
    counts: str
    total: str = "LAUNCHES"
    by: str | None = None
    opt_in: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 compare=False, repr=False)


def _argtypes(codes: str) -> list:
    return [_CTYPES[c] for n, c in re.findall(r"(\d*)([a-zA-Z])", codes)
            for _ in range(int(n or 1))]


def _bind(lib: Library) -> dict:
    """``lib``'s entry points and error function by name, their signatures
    set at the first call of a process."""
    with _LOCK:
        fns = _BOUND.get(lib.name)
        if fns is None:
            cdll = library(lib.name)
            fns = {}
            for entry, codes in lib.entries.items():
                fns[entry] = fn = getattr(cdll, entry)
                fn.argtypes = _argtypes(codes) + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            fns[lib.error] = fn = getattr(cdll, lib.error)
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
            _BOUND[lib.name] = fns
    return fns


def launch(lib: Library, entry: str, device: torch.device, *args,
           label: str | None = None) -> None:
    """Launch ``lib``'s ``entry`` with ``args`` on the current stream of
    CUDA ``device``; raise ``RuntimeError`` on an error code, else count
    the launch (under ``label`` in ``lib.by``)."""
    fns = _BOUND.get(lib.name) or _bind(lib)
    with (lib.lock if lib.opt_in else contextlib.nullcontext()), \
            torch.cuda.device(device):
        err = fns[entry](*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: launch failed: "
                           + fns[lib.error](err).decode())
    count(lib, label)


def count(lib: Library, label: str | None = None) -> None:
    """Count one launch of ``lib`` in its wrapper's counters."""
    mod = sys.modules[lib.counts]
    with _COUNT_LOCK:
        setattr(mod, lib.total, getattr(mod, lib.total) + 1)
        if lib.by:
            getattr(mod, lib.by)[label] += 1


def tally(counts: dict, key: str) -> None:
    """Add 1 to ``counts[key]`` under the launch counters' lock (a count
    of a wrapper's own beside the library's)."""
    with _COUNT_LOCK:
        counts[key] += 1


def reset_counts(lib: Library) -> None:
    """Set ``lib``'s counters to 0."""
    mod = sys.modules[lib.counts]
    with _COUNT_LOCK:
        setattr(mod, lib.total, 0)
        if lib.by:
            by = getattr(mod, lib.by)
            by.update(dict.fromkeys(by, 0))


def u64(values) -> ctypes.Array:
    """``values`` as a C array of uint64 (a ``Q`` argument)."""
    return (ctypes.c_uint64 * len(values))(*values)


def u32(values) -> ctypes.Array:
    """``values`` as a C array of uint32 (an ``I`` argument)."""
    return (ctypes.c_uint32 * len(values))(*values)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device | None = None, *,
          dtype_error: type[Exception] = TypeError) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (and on ``device``, where given): ``dtype_error`` for the dtype,
    ``ValueError`` for the rest."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise dtype_error(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
