"""Stale staging-directory GC shared by atomic writers (the registry).

Writers stage into ``<dir>/tmp.*`` and publish with one ``os.replace``; a
crashed writer leaves its staging directory behind.  This is the part of
the JAX package's ``train.checkpoint`` that the model registry uses; the
rest of that module (the checkpoint save/restore) comes with the LM stack.
"""

from __future__ import annotations

import os
import shutil
import time

#: Default age (seconds) past which an orphaned ``tmp.*`` directory is
#: presumed abandoned and garbage-collected by :func:`gc_stale_tmp`.
TMP_GC_AGE = 3600.0


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
