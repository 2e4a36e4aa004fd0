"""The work a tree's growth needs, at the H100's peaks.

The kernels' roofline shares and ``build_mfu`` take their operations and
bytes from here, never from the program's counters or launch shapes, so
the yardstick reads the same work whatever implements it.  The counts are
the reference's, made while it grows the tree the program's tree is held
to (``bench.reference.Result``): a node is scored unless it is pure,
weighs less than ``2 * min_objs`` or lies at ``max_depth``, and a scored
node needs its cases read once and the non-zero cells of its (A, B, C)
histogram (a cell a (attribute, bin, class) triple its cases hold) written
once and read once.  Cells no case reaches need no work: counting them
would ask more of a kernel than these inputs need.
"""

from __future__ import annotations

import dataclasses

from bench import roofline


@dataclasses.dataclass(frozen=True)
class Work:
    scored_nodes: int
    scored_cases: int       # the cases at the scored nodes, summed
    nonzero_cells: int      # (node, attribute, bin, class) with a case
    nonzero_bins: int       # (node, attribute, bin) with a case
    n_attrs: int
    n_classes: int

    def histogram_s(self) -> float:
        """Each scored case row read once, each non-zero cell written
        once; an add a (case, attribute)."""
        return roofline.bound_s(
            roofline.histogram_bytes(self.scored_cases, self.n_attrs,
                                     self.nonzero_cells),
            roofline.histogram_ops(self.scored_cases, self.n_attrs))

    def _gain_ops(self) -> int:
        # split_gain_ops a non-empty (node, attribute, bin)
        return roofline.split_gain_ops(self.nonzero_bins, 1, 1,
                                       self.n_classes)

    def split_gain_s(self) -> float:
        """``split_gain_bytes`` with its histogram term the non-zero cells:
        each read once, with the node totals, the attribute flags and the
        (node, attribute) outputs."""
        k, a = self.scored_nodes, self.n_attrs
        n_bytes = 4 * self.nonzero_cells + k * 4 + a * 5 + k * a * 8
        return roofline.bound_s(n_bytes, self._gain_ops())

    def build_s(self) -> float:
        """The build's least time: each scored node's cases read once, its
        histogram's non-zero cells written once and read once, and the
        histogram's adds and the scoring's operations."""
        n_bytes = (self.scored_cases * (4 * self.n_attrs + 12)
                   + 2 * 4 * self.nonzero_cells)
        n_ops = (roofline.histogram_ops(self.scored_cases, self.n_attrs)
                 + self._gain_ops())
        return roofline.bound_s(n_bytes, n_ops)


def of_reference(result, *, n_attrs: int, n_classes: int) -> Work:
    return Work(scored_nodes=result.scored_nodes,
                scored_cases=result.scored_cases,
                nonzero_cells=result.nonzero_cells,
                nonzero_bins=result.nonzero_bins, n_attrs=n_attrs,
                n_classes=n_classes)
