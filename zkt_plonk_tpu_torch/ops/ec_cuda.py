"""Kernel K4 (``ec_add_complete``) and its plain PyTorch version — the
counterpart of ``zkt_plonk_tpu/ops/ec_pallas.py``.

Complete projective addition (Renes-Costello-Batina 2015, Algorithm 7,
a = 0) on points ``(..., 3, L)`` int32 of canonical limbs.  For points on
the card the wrapper launches ``csrc/ec_add_complete.cu`` (one thread per
point pair, 3b applied as a small integer, the formula of ``csrc/ec.cuh``
that the MSM's bucket accumulation K4a shares; one instance for L = 16,
BN254's Fq, one for L = 24, the BLS12 base fields); for points on the CPU
it runs the plain version in int64 limb math.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _cuda
from ..fields import cuda as fc
from ..fields.limbs import LIMB_BITS, LIMB_MASK, FieldSpec


@lru_cache(maxsize=None)
def _lazy_offsets(spec: FieldSpec, device: torch.device):
    """Limb vectors D_m of 2m*p whose limbs are large enough that
    D_m - (m canonical values) has no negative limb: subtraction without a
    carry pass (value + 2m*p stays congruent)."""
    L = spec.n_limbs
    out = []
    for m in (1, 2):
        n = [((2 * m * spec.modulus) >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)]
        d = [n[j] + (m << LIMB_BITS) - (m if j else 0) for j in range(L - 1)] + [n[L - 1] - m]
        assert d[L - 1] >= m * int(spec.modulus_limbs[L - 1]), "offset top limb too small"
        out.append(torch.tensor(d, dtype=torch.int64, device=device))
    return tuple(out)


def add_plain(spec: FieldSpec, b3: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """RCB complete add in int64 limb math: the 12 products as 3 stacked
    multiplies (the formula's three multiplicative layers); the additions
    and subtractions between them stay unreduced (limbs < 2^18, which
    ``mul64`` accepts) and only the three outputs are reduced."""
    p, q = torch.broadcast_tensors(p.to(torch.int64), q.to(torch.int64))
    b3 = b3.to(torch.int64)
    D1, D2 = _lazy_offsets(spec, p.device)
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    m_ = lambda a, b: fc.mul64(spec, a, b)

    lhs = torch.stack([X1, Y1, X1 + Y1, Y1 + Z1, X1 + Z1, Z1])
    rhs = torch.stack([X2, Y2, X2 + Y2, Y2 + Z2, X2 + Z2, Z2])
    t0, t1, sxy, syz, sxz, t2 = m_(lhs, rhs).unbind(0)

    t3 = sxy + D2 - t0 - t1  # X1Y2 + X2Y1
    t4 = syz + D2 - t1 - t2  # Y1Z2 + Y2Z1
    t5 = sxz + D2 - t0 - t2  # X1Z2 + X2Z1

    b3t2, b3t5 = m_(torch.stack([t2, t5]), b3).unbind(0)
    m3t0 = 3 * t0
    zs = t1 + b3t2
    td = t1 + D1 - b3t2

    prod3 = m_(torch.stack([t3, t4, b3t5, td, zs, m3t0]), torch.stack([td, b3t5, m3t0, zs, t4, t3]))
    X3 = fc.sub64(spec, prod3[0], prod3[1])
    YZ = fc.add64(spec, prod3[2:6:2], prod3[3:6:2])
    return torch.stack([X3, YZ[0], YZ[1]], dim=-2).to(torch.int32)


def add(spec: FieldSpec, b3: torch.Tensor, b3_int: int, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete add of broadcastable point tensors (..., 3, L).  ``b3`` is
    the limb tensor of 3b and ``b3_int`` its integer value (the kernel
    applies it by double-and-add, so it must be below 256)."""
    L = spec.n_limbs
    for name, t in (("p", p), ("q", q)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32 limbs, got {t.dtype}")
        if t.dim() < 2 or tuple(t.shape[-2:]) != (3, L):
            raise ValueError(f"{name}: expected (..., 3, {L}) points, got {tuple(t.shape)}")
    if p.device.type == "cpu" and q.device.type == "cpu":
        return add_plain(spec, b3, p, q)
    if p.device != q.device or p.device.type != "cuda":
        raise ValueError(f"points on {p.device} and {q.device}")
    if not 0 <= b3_int < 256:
        raise ValueError("ec_add_complete needs 3b < 256")
    p = fc.kernel_ready(p, 2)
    q = fc.kernel_ready(q, 2)
    shape = torch.broadcast_shapes(p.shape, q.shape)
    out = torch.empty(shape, dtype=torch.int32, device=p.device)
    n = out.numel() // (3 * L)
    if n == 0:
        return out
    meta = _cuda.broadcast_meta(shape, p, q, 2)
    fn = _cuda.lib("ec_add_complete").zk_ec_add_complete
    err = fn(
        L, p.data_ptr(), q.data_ptr(), out.data_ptr(), n, len(meta),
        _cuda.ll_array([m[0] for m in meta]),
        _cuda.ll_array([m[1] for m in meta]),
        _cuda.ll_array([m[2] for m in meta]),
        b3_int, _cuda.ec_field_consts(spec), _cuda.stream_ptr(p),
    )
    _cuda.check(err, "ec_add_complete")
    _cuda.count(_cuda.instance("ec_add_complete", L))
    return out
