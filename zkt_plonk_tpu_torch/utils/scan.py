"""Log-depth scans and reductions along one axis of a tensor.

The port's one Hillis-Steele scan and one pairwise-halving reduction, over
any associative binary ``op`` on tensor slices: a field product or sum
(``lambda a, b: fd.mul(spec, a, b)``, kernel K1 on the card) or an EC add
(``lambda a, b: ec.add(spec, b3, a, b)``, kernel K4).  Each level is one
``op`` call over whole slices, so a level is one launch of its kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def scan(op: Op, x: torch.Tensor, axis: int, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``op`` along ``axis`` (Hillis-Steele): log2 k steps
    for k rows, each one clone and one ``op`` over the k - d rows that have
    a neighbour d away.  Row i becomes op(y_i, y_(i-d)), or with ``reverse``
    (a suffix scan) op(y_i, y_(i+d))."""
    axis = axis % x.dim()
    k = x.shape[axis]
    d = 1
    while d < k:
        near, far = (0, d) if reverse else (d, 0)
        nxt = x.clone()
        nxt.narrow(axis, near, k - d).copy_(op(x.narrow(axis, near, k - d), x.narrow(axis, far, k - d)))
        x = nxt
        d <<= 1
    return x


def tree_reduce(op: Op, x: torch.Tensor, axis: int) -> torch.Tensor:
    """``op`` over the k rows along ``axis`` by pairwise halving: row i meets
    row i + k//2 and an odd last row is carried to the next level, k - 1
    pairings in ceil(log2 k) calls of ``op``.  Returns ``x`` with ``axis``
    removed."""
    axis = axis % x.dim()
    k = x.shape[axis]
    while k > 1:
        half = k // 2
        merged = op(x.narrow(axis, 0, half), x.narrow(axis, half, half))
        x = torch.cat([merged, x.narrow(axis, k - 1, 1)], dim=axis) if k % 2 else merged
        k = x.shape[axis]
    return x.select(axis, 0)
