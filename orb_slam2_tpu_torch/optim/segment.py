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

import torch

# rows of the longest target from which each (lane, target) is reduced
# by a block of threads rather than by one thread
LONG_SEGMENTS = 64


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
    Choosing reads the longest segment back to the host once, when the
    sum is made."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx = idx.long()
        self.n = int(n)
        if self.idx.is_cuda:
            self.order = torch.argsort(self.idx, stable=True)
            self.starts = torch.searchsorted(
                self.idx[self.order],
                torch.arange(self.n + 1, device=self.idx.device))
            self.lengths = self.starts.diff()
            self.long = self.n > 0 and int(self.lengths.max()) > LONG_SEGMENTS
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
