"""Per-target sums of rows that repeat from run to run.

``Tensor.index_add_`` on a CUDA tensor adds with atomics, whose order
varies between runs; the map's solvers then give answers that differ in
their last bits, and the differences grow through the thresholds of
mapping and loop closing until two runs of one sequence close different
loops.  The JAX package's scatter-adds repeat on the TPU.  ``IndexSum``
sorts the rows by target once (stably) and reduces each target's rows
with ``segment_reduce``, whose reductions on the card have a fixed
order; on the CPU it is ``index_add_``.
"""
from __future__ import annotations

import numpy as np
import torch

# rows of the longest target from which each (lane, target) is reduced
# by a block of threads rather than by one thread
LONG_SEGMENTS = 64


def longest_segment(idx, n: int) -> int:
    """``IndexSum``'s ``longest`` from a host index vector: the row count
    of its longest target, clamped at ``LONG_SEGMENTS + 1``.  Only the
    side of ``LONG_SEGMENTS`` it falls on chooses the reduction, so as a
    static argument of a CUDA graph the clamped count keeps one capture
    per side (the exact count made one per problem)."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return 0
    return min(int(np.bincount(idx.reshape(-1).astype(np.int64),
                               minlength=n).max()), LONG_SEGMENTS + 1)


def sort_layout(idx: torch.Tensor, n: int):
    """``IndexSum``'s layout of a long index vector on the card: the
    stable sort of the rows by target and each target's first row in
    it, (order, starts (n + 1,)).  A phased solver makes it once, in its
    first captured step, and every later step sums with it."""
    order = torch.argsort(idx, stable=True)
    return order, torch.searchsorted(
        idx[order], torch.arange(n + 1, device=idx.device))


class IndexSum:
    """``IndexSum(idx, n)(vals)`` is ``zeros(n, ...).index_add_(0, idx,
    vals)`` computed the same way on every run; the sort of ``idx`` is
    made once and serves every call (the solvers reduce many quantities
    over one observation layout).

    On the card, rows of two or more dimensions whose targets all have
    few rows (a map point's observations) are summed by one thread per
    (target, lane) in row order, which is ``index_add_``'s order on the
    CPU.  Where one target has many (a keyframe's thousands of
    observations, or the row that takes a padded problem's filler) the
    rows are laid out lane by lane and each (lane, target) segment is
    reduced by a block of threads (a tree), as vectors always are.
    ``longest`` is the row count of the longest target where the caller
    knows it (a layout built on the host); otherwise choosing reads it
    back from the card once, when the sum is made.  Given, nothing here
    waits for the card, so the sum can be captured in a CUDA graph (the
    choice is then the caller's static argument).  ``layout``: the
    :func:`sort_layout` of ``idx`` where the caller made it already."""

    def __init__(self, idx: torch.Tensor, n: int, longest: int | None = None,
                 layout=None):
        self.idx = idx.long()
        self.n = int(n)
        if self.idx.is_cuda:
            self.order, self.starts = layout if layout is not None \
                else sort_layout(self.idx, self.n)
            self.lengths = self.starts.diff()
            if longest is None:
                longest = int(self.lengths.max()) if self.n > 0 else 0
            self.long = longest > LONG_SEGMENTS
            self._offsets = {}      # lane count -> (lane, target) offsets

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        if not vals.is_cuda:
            out = vals.new_zeros((self.n,) + tuple(vals.shape[1:]))
            return out.index_add_(0, self.idx, vals)
        # unsafe: the segments cover the rows by construction; the check
        # would read them back to the host
        if vals.dim() == 1 or not self.long:
            return torch.segment_reduce(
                torch.index_select(vals, 0, self.order), "sum",
                lengths=self.lengths, axis=0, unsafe=True)
        n_rows = len(vals)
        lanes = torch.index_select(vals.reshape(n_rows, -1).T, 1,
                                   self.order)               # (D, O)
        n_lanes = lanes.shape[0]
        offsets = self._offsets.get(n_lanes)
        if offsets is None:
            # made on the card: a host tensor copied in would wait for
            # the stream
            base = torch.arange(n_lanes + 1, device=vals.device) * n_rows
            offsets = torch.cat([(base[:-1, None]
                                  + self.starts[None, :-1]).reshape(-1),
                                 base[-1:]])
            self._offsets[n_lanes] = offsets
        out = torch.segment_reduce(lanes.reshape(-1), "sum",
                                   offsets=offsets, axis=0, unsafe=True)
        return out.reshape(n_lanes, self.n).T.reshape(
            (self.n,) + tuple(vals.shape[1:]))
