"""Versioned on-disk model registry with atomic publish and hot-swap.

Layout (one directory per model name, one per published version)::

    <root>/<name>/
        v00000001/
            model.npz        # every Forest array, np.savez
            manifest.json    # version, schema, per-array crc32, metadata
        v00000002/...
        tmp.<ver>.<pid>.<seq>/   # in-flight publish (crashed ones are GC'd)

The format is the JAX package's registry's, byte for byte (same npz keys,
dtypes, manifest and crc32s), so a version published by either package
loads in the other.  Publishing follows the ``tmp.* + os.replace``
discipline of the checkpoint writers: every file lands in a ``tmp.*`` staging
directory and one atomic rename makes the version visible — a crash between
tmp-write and rename leaves :func:`latest_valid` serving the prior version,
and the torn staging directory is garbage-collected once it is old enough
to be presumed abandoned.

:class:`ModelHandle` is the serving-side view: it pins the newest valid
version, ``refresh()`` hot-swaps to later publishes, and canary / shadow
routing splits traffic between the pinned stable version and a candidate by
a deterministic per-uid hash fraction (same uid -> same arm, every process).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import zipfile
import zlib

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import Tree
from repro_torch.infer.forest import FIELDS as _FIELDS
from repro_torch.infer.forest import Forest, forest_from_numpy
from repro_torch.train.checkpoint import TMP_GC_AGE, gc_stale_tmp

_MANIFEST = "manifest.json"
_MODEL = "model.npz"
_PUB_SEQ = itertools.count()
SCHEMA_VERSION = 1


def _version_dir(version: int) -> str:
    return f"v{version:08d}"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_forest(path: str, forest: Forest, *, version: int,
                metadata: dict | None = None) -> None:
    """Write ``model.npz`` + ``manifest.json`` into an existing directory."""
    arrays = forest.to_numpy()
    np.savez(os.path.join(path, _MODEL), **arrays)
    manifest = {
        "schema": SCHEMA_VERSION,
        "version": version,
        "n_trees": forest.n_trees,
        "capacity": forest.capacity,
        "n_classes": forest.n_classes,
        "n_levels": forest.n_levels,
        "metadata": metadata or {},
        "arrays": {f: {"shape": list(a.shape), "dtype": str(a.dtype),
                       "crc32": _crc(a)}
                   for f, a in arrays.items()},
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load(path: str, device=None) -> tuple[Forest, dict]:
    """Load a published version directory -> (Forest on ``device``,
    manifest).  ``device=None`` means the card."""
    dev = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _MODEL)) as z:
        forest = forest_from_numpy(z, dev)
    return forest, manifest


def verify(path: str) -> bool:
    """True iff the version's arrays match the manifest checksums."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, _MODEL)) as z:
            for field, meta in manifest["arrays"].items():
                arr = z[field]
                if list(arr.shape) != meta["shape"] \
                        or str(arr.dtype) != meta["dtype"] \
                        or _crc(arr) != meta["crc32"]:
                    return False
        return set(manifest["arrays"]) == set(_FIELDS)
    except (OSError, ValueError, KeyError, TypeError, zipfile.BadZipFile):
        return False


_RETIRED_PREFIX = "retired."


def list_versions(root: str, name: str) -> list[str]:
    """Published version directories, oldest first (validity not checked)."""
    d = os.path.join(root, name)
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, v) for v in sorted(os.listdir(d))
            if v.startswith("v") and v[1:].isdigit()]


def list_retired(root: str, name: str) -> list[str]:
    """Rolled-back version directories, oldest first."""
    d = os.path.join(root, name)
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, v) for v in sorted(os.listdir(d))
            if v.startswith(_RETIRED_PREFIX)
            and v[len(_RETIRED_PREFIX) + 1:].isdigit()]


def _next_version(root: str, name: str) -> int:
    """Next version number, never reusing one a retired dir ever held —
    a re-publish after :func:`rollback` must not collide with the path a
    serving handle may still have pinned."""
    nums = [int(os.path.basename(p)[1:]) for p in list_versions(root, name)]
    nums += [int(os.path.basename(p)[len(_RETIRED_PREFIX) + 1:])
             for p in list_retired(root, name)]
    return 1 + (max(nums) if nums else 0)


def latest_valid(root: str, name: str, *,
                 gc_tmp_age: float | None = TMP_GC_AGE) -> str | None:
    """Newest version passing checksum verification (same contract as
    ``train.checkpoint.latest_valid``, including stale-``tmp.*`` GC)."""
    d = os.path.join(root, name)
    if not os.path.isdir(d):
        return None
    if gc_tmp_age is not None:
        gc_stale_tmp(d, max_age=gc_tmp_age)
    for path in reversed(list_versions(root, name)):
        if verify(path):
            return path
    return None


def publish(root: str, name: str, model: Forest | Tree, *,
            metadata: dict | None = None,
            weights=None, keep_last: int | None = None) -> str:
    """Atomically publish the next version of ``name``; returns its path.

    Accepts a single :class:`Tree` (packed as a 1-tree forest on the tree's
    device) or a :class:`Forest`.  The version directory appears with one
    ``os.replace`` — readers never observe a partially-written model.

    ``keep_last=N`` runs retention GC after the publish: only the N newest
    version directories (and the N newest retired ones) survive, so version
    dirs no longer accumulate forever.  Pick N larger than the rollback /
    canary depth you need — a pinned :class:`ModelHandle` whose version is
    GC'd keeps serving from memory but cannot re-load it.
    """
    if isinstance(model, Tree):
        model = Forest.pack([model], weights=weights,
                            device=model.node_attr.device)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    version = _next_version(root, name)
    final = os.path.join(d, _version_dir(version))
    tmp = os.path.join(d, f"tmp.{version}.{os.getpid()}.{next(_PUB_SEQ)}")
    os.makedirs(tmp)
    save_forest(tmp, model, version=version, metadata=metadata)
    os.replace(tmp, final)
    if keep_last is not None:
        gc_versions(root, name, keep_last=keep_last)
    return final


def gc_versions(root: str, name: str, *, keep_last: int) -> list[str]:
    """Delete all but the ``keep_last`` newest published (and retired)
    version directories; returns the removed paths, oldest first."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    removed = []
    for paths in (list_versions(root, name), list_retired(root, name)):
        for p in paths[:-keep_last] if keep_last < len(paths) else []:
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    return removed


def rollback(root: str, name: str) -> str | None:
    """Retire the newest version so :func:`latest_valid` re-points below it.

    The newest version directory is renamed to ``retired.v*`` (one atomic
    ``os.replace`` — readers never observe a half-retired version), which
    removes it from :func:`list_versions` / :func:`latest_valid` without
    destroying the bits.  Returns the new ``latest_valid`` path, or ``None``
    when no published version remains.  A later :func:`publish` never reuses
    the retired number.  Raises :class:`FileNotFoundError` when there is no
    version to retire.
    """
    versions = list_versions(root, name)
    if not versions:
        raise FileNotFoundError(
            f"no published version of {name!r} under {root!r} to roll back")
    newest = versions[-1]
    d = os.path.dirname(newest)
    os.replace(newest,
               os.path.join(d, _RETIRED_PREFIX + os.path.basename(newest)))
    return latest_valid(root, name)


def manifest_of(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


# ------------------------------------------------------------------ serving

#: Hash-space resolution for canary fractions (1e-4 granularity).
_ROUTE_BUCKETS = 10_000


def route_bucket(uid: int) -> int:
    """Deterministic per-uid bucket in [0, _ROUTE_BUCKETS)."""
    return zlib.crc32(str(int(uid)).encode()) % _ROUTE_BUCKETS


@dataclasses.dataclass
class _Loaded:
    path: str
    forest: Forest
    manifest: dict


class ModelHandle:
    """Hot-swappable serving view of one registry entry.

    * ``refresh()`` re-resolves :func:`latest_valid` and swaps the stable
      model in place when a newer valid version landed — the serving loop
      never restarts.
    * ``set_canary(path, fraction)`` routes ``fraction`` of uids (by
      deterministic hash) to a candidate version; ``clear_canary()``,
      ``promote_canary()`` end the experiment.
    * ``shadow=True`` makes the canary a *shadow*: every request is served
      by stable, and the service mirrors the batch to the canary model for
      comparison only (no user-visible traffic shift).

    Every version it loads lives on ``device`` (None: the card).
    """

    def __init__(self, root: str, name: str, *,
                 canary_fraction: float = 0.0, shadow: bool = False,
                 device=None):
        self.root = root
        self.name = name
        self.device = resolve_device(device)
        self.canary_fraction = float(canary_fraction)
        self.shadow = shadow
        self._stable: _Loaded | None = None
        self._canary: _Loaded | None = None
        self.refresh()
        if self._stable is None:
            raise FileNotFoundError(
                f"no valid published version of {name!r} under {root!r}")

    # ------------------------------------------------------------- versions
    def refresh(self) -> bool:
        """Swap to the newest valid version; True when a swap happened."""
        path = latest_valid(self.root, self.name)
        if path is None or (self._stable and self._stable.path == path):
            return False
        forest, manifest = load(path, self.device)
        self._stable = _Loaded(path, forest, manifest)
        return True

    @property
    def stable_path(self) -> str:
        return self._stable.path

    @property
    def stable(self) -> Forest:
        return self._stable.forest

    @property
    def canary(self) -> Forest | None:
        return self._canary.forest if self._canary else None

    @property
    def canary_path(self) -> str | None:
        return self._canary.path if self._canary else None

    # --------------------------------------------------------------- canary
    def set_canary(self, path: str, fraction: float | None = None,
                   *, shadow: bool | None = None) -> None:
        if not verify(path):
            raise ValueError(f"canary candidate fails verification: {path}")
        forest, manifest = load(path, self.device)
        self._canary = _Loaded(path, forest, manifest)
        if fraction is not None:
            self.canary_fraction = float(fraction)
        if shadow is not None:
            self.shadow = shadow

    def clear_canary(self) -> None:
        self._canary = None
        self.canary_fraction = 0.0

    def promote_canary(self) -> None:
        """Make the canary the stable model (in-memory hot swap)."""
        if self._canary is None:
            raise ValueError("no canary to promote")
        self._stable, self._canary = self._canary, None
        self.canary_fraction = 0.0

    # -------------------------------------------------------------- routing
    def route(self, uid: int) -> str:
        """``"stable" | "canary"`` arm for this uid (shadow never shifts)."""
        if self._canary is None or self.shadow:
            return "stable"
        frac = min(max(self.canary_fraction, 0.0), 1.0)
        in_canary = route_bucket(uid) < int(frac * _ROUTE_BUCKETS)
        return "canary" if in_canary else "stable"

    def model_for(self, uid: int) -> Forest:
        return self.canary if self.route(uid) == "canary" else self.stable

    def shadow_model(self) -> Forest | None:
        """The mirror target, when shadow mode is armed."""
        return self.canary if (self.shadow and self._canary) else None
