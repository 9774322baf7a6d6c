"""Spatially-uniform keypoint selection with static shapes, in torch.

Port of ``orb_slam2_tpu/ops/distribute.py``, the functional equivalent
of ORBextractor::DistributeOctTree (src/ORBextractor.cc:690-1008): fixed
grid cells sized so #cells ~= 2n, the top-k corners per cell, a
priority per candidate (cell rank first, then response), and the global
top-n by priority.

Tie order: ``lax.top_k`` returns equal values lowest index first, and
``torch.topk`` promises no order, while integer FAST scores tie often.
:func:`topk_lowest_index` makes the order explicit with a stable sort.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def topk_lowest_index(x: torch.Tensor, k: int):
    """Largest ``k`` entries along the last dim, equal values in
    increasing index order (the ``lax.top_k`` contract)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_topk(
    corner_mask: torch.Tensor,
    score: torch.Tensor,
    n_target: int,
    k_per_cell: int = 3,
    cell: int | None = None,
):
    """Select up to ``n_target`` corners, evenly spread.

    corner_mask, score: (H, W).  Returns (ys, xs, scores, valid), each
    (n_target,), sorted by selection priority; slots beyond the number
    of available corners have valid=False."""
    h, w = corner_mask.shape
    dev = score.device
    if cell is None:
        cell = max(8, int(math.sqrt(h * w / max(2 * n_target, 1))))
    ph = (-h) % cell
    pw = (-w) % cell
    s = torch.where(corner_mask, score,
                    torch.full_like(score, float("-inf")))
    s = F.pad(s, (0, pw, 0, ph), value=float("-inf"))
    hp, wp = h + ph, w + pw
    hc, wc = hp // cell, wp // cell

    tiles = (s.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3)
             .reshape(hc * wc, cell * cell))
    vals, idx = topk_lowest_index(tiles, k_per_cell)  # (cells, k)

    cid = torch.arange(hc * wc, dtype=torch.int64, device=dev)
    ys = (cid // wc)[:, None] * cell + idx // cell
    xs = (cid % wc)[:, None] * cell + idx % cell

    rank = torch.arange(k_per_cell, dtype=torch.float32,
                        device=dev)[None, :].expand_as(vals)
    valid = torch.isfinite(vals)
    # priority key: lower is better. rank dominates (score <= 255 always).
    key = torch.where(valid, rank * 1024.0 - vals,
                      torch.full_like(vals, float("inf")))

    key = key.reshape(-1)
    ys = ys.reshape(-1)
    xs = xs.reshape(-1)
    scores = vals.reshape(-1)

    n_take = min(n_target, key.shape[0])
    neg_top, sel = topk_lowest_index(-key, n_take)
    out_y = ys[sel]
    out_x = xs[sel]
    out_s = scores[sel]
    out_valid = torch.isfinite(-neg_top)
    if n_take < n_target:
        pad = n_target - n_take
        out_y = torch.cat([out_y, out_y.new_zeros(pad)])
        out_x = torch.cat([out_x, out_x.new_zeros(pad)])
        out_s = torch.cat([out_s, out_s.new_full((pad,), float("-inf"))])
        out_valid = torch.cat([out_valid, out_valid.new_zeros(pad)])
    return (out_y.to(torch.int32), out_x.to(torch.int32), out_s, out_valid)
