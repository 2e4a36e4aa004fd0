"""Checkpoints of the port: atomic, integrity-tagged, on the JAX package's
on-disk contract.  The port of ``repro.train.checkpoint``.

  * **Layout** -- ``<dir>/step_<10 digits>/`` holds one ``.npy`` a leaf and
    ``manifest.json`` with the step, ``extra`` and, for each leaf key, its
    file, shape, dtype string and crc32.  Keys are the port's own state
    paths: ``params/layers/0/attn/wq``, ``m/...``, ``v/...``, ``step``
    (a module's parameter names with ``/`` for ``.``); a file is the key
    with ``__`` for ``/``.  bfloat16 leaves are stored as their raw bytes
    (uint8) with dtype ``"bfloat16"``, as the JAX package stores them, so a
    directory either package writes passes the other's :func:`verify`.
  * **Atomicity** -- written to ``<dir>/tmp.<step>.<pid>.<n>``, then moved
    into place by one ``os.replace``.
  * **Integrity** -- :func:`latest_valid` skips a checkpoint whose leaves
    fail their crc32 (a torn write) and collects stale ``tmp.*``
    directories (:func:`gc_stale_tmp`, shared with the model registry).
  * **Async** -- ``save(..., blocking=False)`` copies the state to host
    memory at once (the consistency point) and writes on a thread; the
    returned :class:`SaveHandle` re-raises the writer's error on ``wait()``.

:func:`restore` writes the checkpoint's values into the tensors of the
state it is given (no second copy of the state on the card) and returns
that state with the saved step.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_MANIFEST = "manifest.json"
_SAVE_SEQ = itertools.count()

#: Default age (seconds) past which an orphaned ``tmp.*`` directory is
#: presumed abandoned and garbage-collected by :func:`gc_stale_tmp`.
TMP_GC_AGE = 3600.0


class SaveHandle(str):
    """Path-like result of :func:`save`: the checkpoint's path, and for a
    ``blocking=False`` save its writer thread.  ``wait()`` joins it and
    re-raises any exception the writer hit."""

    _thread: threading.Thread | None = None
    _box: dict | None = None

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self, timeout: float | None = None) -> str:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"checkpoint writer for {self} still "
                                   f"running after {timeout}s")
        if self._box and self._box.get("exc") is not None:
            raise self._box["exc"]
        return str(self)


def _join(prefix: str, name) -> str:
    """The key of ``name`` under ``prefix``; a dotted parameter name
    becomes a path."""
    name = str(name).replace(".", "/")
    return f"{prefix}/{name}" if prefix else name


def _items(tree: Any, prefix: str = ""):
    """(key, leaf) pairs of a state in a fixed order; containers are
    dataclasses, modules (their parameters), mappings, lists and tuples."""
    def key(name):
        return _join(prefix, name)
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield key(name), p
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), key(f.name))
    elif isinstance(tree, Mapping):
        for name, sub in tree.items():
            yield from _items(sub, key(name))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, key(i))
    else:
        yield prefix, tree


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _storable(leaf) -> tuple[np.ndarray, str, list[int]]:
    """(array to write, dtype string, shape) of a leaf, copied to the host.
    bfloat16 becomes its raw bytes (numpy has no bfloat16)."""
    if not isinstance(leaf, torch.Tensor):
        # a Python int is the step: int32, as the JAX state's
        arr = np.asarray(leaf, np.int32 if type(leaf) is int else None)
        return arr, str(arr.dtype), list(arr.shape)
    t = leaf.detach()
    shape = list(t.shape)
    if t.dtype == torch.bfloat16:
        t = (t if t.dim() else t.reshape(1)).contiguous().view(torch.uint8)
    return t.cpu().contiguous().numpy(), _dtype_name(leaf), shape


def _load(path: str, meta: dict) -> np.ndarray:
    """A leaf's stored array, checked against its manifest entry: its shape
    (bfloat16: its byte count) and dtype; raises ValueError."""
    arr = np.load(os.path.join(path, meta["file"]))
    shape, dtype = tuple(meta["shape"]), meta["dtype"]
    if dtype == "bfloat16":
        if arr.dtype != np.uint8 or arr.size != 2 * int(np.prod(shape)):
            raise ValueError(f"{meta['file']}: not {shape} bfloat16 bytes")
        return np.ascontiguousarray(arr)
    if str(arr.dtype) != dtype or tuple(arr.shape) != shape:
        raise ValueError(f"{meta['file']}: {arr.dtype} {arr.shape}, "
                         f"manifest {dtype} {shape}")
    return arr


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save(directory: str, step: int, tree: Any, *, extra: dict | None = None,
         blocking: bool = True) -> SaveHandle:
    """Write checkpoint ``<directory>/step_<step>`` of ``tree`` (a
    :class:`~repro_torch.train.train_step.TrainState`, or any tree of
    tensors, arrays and numbers).  The leaves are copied to the host before
    this returns; with ``blocking=False`` the files are written on a daemon
    thread: call ``handle.wait()`` before relying on them."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: _storable(leaf) for k, leaf in _items(tree)}
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = os.path.join(directory,
                       f"tmp.{step}.{os.getpid()}.{next(_SAVE_SEQ)}")

    def write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for key, (arr, dtype, shape) in flat.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][key] = {"file": fn, "shape": shape,
                                       "dtype": dtype, "crc32": _crc(arr)}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    handle = SaveHandle(final)
    if blocking:
        write()
        return handle
    box: dict = {"exc": None}

    def run():
        try:
            write()
        except BaseException as e:      # surfaced by SaveHandle.wait()
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    handle._thread, handle._box = t, box
    t.start()
    return handle


def verify(path: str) -> bool:
    """True if every leaf of the manifest loads with its shape and dtype
    and matches its crc32."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        return all(_crc(_load(path, meta)) == meta["crc32"]
                   for meta in manifest["leaves"].values())
    except (OSError, ValueError, KeyError, TypeError):
        return False


def gc_stale_tmp(directory: str, *, max_age: float = TMP_GC_AGE) -> list[str]:
    """Delete ``tmp.*`` directories older than ``max_age`` seconds.

    Crashed async writers leave these behind (the atomic ``os.replace``
    never ran); anything older than ``max_age`` cannot belong to a live
    writer and is reclaimed.  Returns the removed paths.
    """
    removed = []
    now = time.time()
    for d in os.listdir(directory):
        if not d.startswith("tmp."):
            continue
        path = os.path.join(directory, d)
        try:
            if now - os.path.getmtime(path) >= max_age:
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
        except OSError:
            continue
    return removed


def latest_valid(directory: str, *,
                 gc_tmp_age: float | None = TMP_GC_AGE) -> str | None:
    """The newest ``step_*`` checkpoint of ``directory`` that verifies."""
    if not os.path.isdir(directory):
        return None
    if gc_tmp_age is not None:
        gc_stale_tmp(directory, max_age=gc_tmp_age)
    steps = sorted((d for d in os.listdir(directory)
                    if d.startswith("step_")), reverse=True)
    for d in steps:
        path = os.path.join(directory, d)
        if verify(path):
            return path
    return None


def _restore_leaf(arr: np.ndarray, meta: dict, like, key: str):
    shape = tuple(meta["shape"])
    like_shape = tuple(like.shape) if hasattr(like, "shape") else ()
    if shape != like_shape:
        raise ValueError(f"shape mismatch for {key}: {shape} vs "
                         f"{like_shape}")
    src = torch.from_numpy(arr)
    if meta["dtype"] == "bfloat16":
        src = src.view(torch.bfloat16).reshape(shape)
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            like.copy_(src)
        return like
    if isinstance(like, np.ndarray):
        return src.float().numpy().astype(like.dtype)
    return type(like)(src.item())


def _rebuild(tree: Any, leaves: dict, prefix: str = ""):
    def key(name):
        return _join(prefix, name)
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            leaves[key(name)](p)
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves, key(f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return type(tree)({k: _rebuild(sub, leaves, key(k))
                           for k, sub in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves, key(i))
                          for i, sub in enumerate(tree))
    return leaves[prefix](tree)


def restore(path: str, like: Any) -> Any:
    """``like`` (a state or tree of the saved structure) with the values of
    checkpoint ``path``: tensors are overwritten in place (on their own
    device, in their own dtype), numbers and arrays are replaced.  Raises
    ``ValueError`` on a shape that differs and ``KeyError`` on a leaf the
    checkpoint lacks."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    def loader(key):
        def load(like_leaf):
            meta = manifest["leaves"][key]
            return _restore_leaf(_load(path, meta), meta, like_leaf, key)
        return load

    keys = {k: loader(k) for k, _ in _items(like)}
    return _rebuild(like, keys)


def manifest_step(path: str) -> int:
    with open(os.path.join(path, _MANIFEST)) as f:
        return int(json.load(f)["step"])
