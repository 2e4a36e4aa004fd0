"""Reduce a ``torch.profiler`` trace of the card to what the metrics read.

The method of ``src/repro_torch/profile_build.py`` at commit
fe76ba3c169015bc8474eaf345bd872003045a00 (device activity only; busy time,
idle share, device time by kernel), rewritten for a window of many trees.

The profiler records device activity only (kernels, copies, fills): host
op events would multiply the trace without adding device time.  Its
timestamps are nanoseconds of the Unix clock; the host spans (the
program's ``Tracer`` spans and the harness's ``tree`` spans, on
``time.perf_counter``) are moved onto that clock by one offset read when
the window opens.  The card's work is taken as the union of its
operations' intervals, clipped to the window.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

# the kernels whose roofline shares are read, by a part of their names
KERNELS = {"histogram": "frontier_histogram_kernel",
           "split_gain": "split_gain"}
# host activities an idle gap can fall in, innermost first
PHASES = ("splitPre", "splitAtt", "splitPost")


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    op_s: dict[str, float]          # device seconds by operation name
    idle_s: dict[str, float]        # idle seconds by host activity

    def kernel_s(self, kernel: str) -> float:
        part = KERNELS[kernel]
        return sum(s for name, s in self.op_s.items() if part in name)

    def top(self, table: dict[str, float], n: int = 10) -> list:
        """The ``n`` largest entries, their names cut to 96 characters."""
        return [[name.removeprefix("void ")[:96], s] for name, s in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def device_ops(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of each device operation of a profile."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def _spans_in(spans: dict[str, list[tuple[int, int]]], names
              ) -> tuple[np.ndarray, np.ndarray, list[str]]:
    rows = sorted((s, e, name) for name in names for s, e in
                  spans.get(name, ()))
    return (np.array([r[0] for r in rows], np.int64),
            np.array([r[1] for r in rows], np.int64), [r[2] for r in rows])


def reduce(ops: list[tuple[str, int, int]], window: tuple[int, int],
           spans: dict[str, list[tuple[int, int]]]) -> DeviceTrace:
    """``ops`` inside ``window`` (Unix ns); ``spans`` are the host spans by
    name on the same clock (``tree``, ``superstep`` and the phases)."""
    w0, w1 = window
    op_s: dict[str, float] = collections.defaultdict(float)
    starts = np.array([o[1] for o in ops], np.int64).clip(w0, w1)
    ends = np.array([o[2] for o in ops], np.int64).clip(w0, w1)
    for (name, _, _), s, e in zip(ops, starts.tolist(), ends.tolist()):
        if e > s:
            op_s[name] += (e - s) / 1e9
    keep = ends > starts
    order = np.argsort(starts[keep], kind="stable")
    starts, ends = starts[keep][order], ends[keep][order]
    # an idle gap opens where an operation starts after every earlier one
    # has ended
    reach = np.maximum.accumulate(np.concatenate([[w0], ends]))
    gap_lo = np.concatenate([reach[:-1], reach[-1:]])
    gap_hi = np.concatenate([starts, [w1]])
    open_ = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[open_], gap_hi[open_]
    length = (gap_hi - gap_lo) / 1e9
    mid = (gap_lo + gap_hi) // 2
    label = np.full(mid.size, "between trees (harness)", dtype=object)
    for names, what in ((["tree"], "build entry (outside supersteps)"),
                        (["superstep"], "superstep (between phases)"),
                        (PHASES, None)):
        s_lo, s_hi, which = _spans_in(spans, names)
        if not s_lo.size:
            continue
        i = np.searchsorted(s_lo, mid, side="right") - 1
        inside = (i >= 0) & (mid < s_hi[np.clip(i, 0, None)])
        label[inside] = (what if what is not None
                         else np.array(which, dtype=object)[i[inside]])
    names, inverse = np.unique(label.astype(str), return_inverse=True)
    sums = np.bincount(inverse, weights=length, minlength=names.size)
    window_s = (w1 - w0) / 1e9
    return DeviceTrace(window_s=window_s,
                       busy_s=window_s - float(length.sum()),
                       op_s=dict(op_s),
                       idle_s={str(n): float(v) for n, v in
                               zip(names, sums)})
