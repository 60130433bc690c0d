"""Device elliptic-curve point arithmetic (complete projective formulas).

Points are ``(..., 3, L)`` int32 projective (X:Y:Z) coordinates over the
base field, identity = (0:1:0).  Addition is the Renes-Costello-Batina
complete formula for a = 0 short-Weierstrass curves (branch-free, valid for
identity, doubling and inverses); on the card it is kernel K4
(``ops/ec_cuda.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from ..fields import device as fd
from ..fields.limbs import FieldSpec, int_to_limbs, ints_to_array, limbs_to_int
from . import ec_cuda


class B3(NamedTuple):
    """The curve constant 3b: its limbs (for the plain version) and its
    integer value (the kernel applies it as a small integer: 9 on BN254)."""

    limbs: torch.Tensor
    value: int


def identity(spec: FieldSpec, shape=(), device="cuda") -> torch.Tensor:
    """(0 : 1 : 0)."""
    dev = _cuda.require_cuda(device)
    pt = torch.zeros((3, spec.n_limbs), dtype=torch.int32, device=dev)
    pt[1, 0] = 1
    return pt.expand(*shape, 3, spec.n_limbs)


def from_affine_host(spec: FieldSpec, points) -> np.ndarray:
    """Host affine points [(x, y) or None] -> (n, 3, L) projective array."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(int(pt[0])), ys.append(int(pt[1])), zs.append(1)
    return np.stack(
        [
            ints_to_array(xs, spec.n_limbs),
            ints_to_array(ys, spec.n_limbs),
            ints_to_array(zs, spec.n_limbs),
        ],
        axis=1,
    )


def to_affine_host(spec: FieldSpec, arr):
    """(..., 3, L) points (tensor or array) -> list of host affine points/None."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    flat = np.asarray(arr).reshape(-1, 3, arr.shape[-1])
    out = []
    p = spec.modulus
    for pt in flat:
        x, y, z = (limbs_to_int(r) for r in pt)
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p)
            out.append((x * zi % p, y * zi % p))
    return out


def normalize(spec: FieldSpec, points: torch.Tensor) -> torch.Tensor:
    """(n, 3, L) projective points -> the same points as (X/Z : Y/Z : 1):
    one batch inversion of the Z column (``fd.batch_inverse``: K1 scans and
    one K2 on the card) and two K1 products.  A point with Z = 1 comes back
    bit for bit.  Raises on a point with Z = 0 (the identity has no such
    form); that check makes the host wait for the card once."""
    z = points[:, 2]
    if bool(fd.is_zero(spec, z).any()):
        raise ValueError("a point with Z = 0 (the identity) has no Z = 1 form")
    xy = fd.mul(spec, points[:, :2], fd.batch_inverse(spec, z)[:, None])
    return torch.cat([xy, fd.one(spec, (points.shape[0], 1), device=points.device)], dim=1)


def add(spec: FieldSpec, b3: B3, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition (RCB 2015, Algorithm 7, a = 0).

    ``b3`` is the curve constant from ``b3_const``.  Shapes broadcast.
    """
    return ec_cuda.add(spec, b3.limbs, b3.value, p, q)


def double(spec: FieldSpec, b3: B3, p: torch.Tensor) -> torch.Tensor:
    return add(spec, b3, p, p)


def neg(spec: FieldSpec, p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[..., 0, :], fd.neg(spec, p[..., 1, :]), p[..., 2, :]], dim=-2)


def b3_const(spec: FieldSpec, b: int, device="cuda") -> B3:
    dev = _cuda.require_cuda(device)
    v = (3 * b) % spec.modulus
    return B3(torch.tensor(int_to_limbs(v, spec.n_limbs).astype(np.int32), device=dev), v)
