"""Vectorized prime-field arithmetic on limb tensors.

Every function takes and returns ``torch.int32`` tensors of canonical
16-bit limbs, ``(..., L)`` (see ``fields/limbs.py``), and runs on the device
its inputs live on.  On the card ``mul``/``add``/``sub`` launch kernel K1
and ``pow_const``/``inv`` kernel K2 (``fields/cuda.py``); on the CPU the
same wrappers run their plain PyTorch versions.  Constructors take
``device=`` (default ``"cuda"``); ``upload`` stages host ints.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _cuda
from ..utils import profiling
from ..utils.scan import scan
from . import cuda as fc
from .limbs import LIMB_BITS, FieldSpec

I32 = torch.int32


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fc.binop(spec, "add", a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fc.binop(spec, "sub", a, b)


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p for canonical inputs (< p), broadcasting."""
    return fc.binop(spec, "mul", a, b)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, zeros(spec, (), device=a.device), a)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, with cond shaped like a[..., 0] (no limb axis)."""
    return torch.where(cond.unsqueeze(-1), a, b)


def upload(n_limbs: int, cols: Sequence[Sequence[int]], device) -> torch.Tensor:
    """k columns of equally many host ints, each below 2^(16 n_limbs) ->
    (k, rows, n_limbs) int32 limbs on ``device``: one copy.

    The limbs cross as the 16 bits they hold (``v.to_bytes`` is already the
    little-endian limbs), written once into a host uint16 tensor and widened
    to int32 on the device.  For a card the host tensor is pinned, from
    torch's caching host allocator, and the copy is an asynchronous DMA on
    the current stream; the allocator keeps the block until that copy has
    completed, so a block is never rewritten under a copy in flight.
    Counted in the recorder's ``h2d_copies``, ``h2d_bytes`` (the bytes
    copied) and ``h2d_pinned_bytes`` (those copied from pinned memory)."""
    dev = torch.device(device)
    pinned = dev.type == "cuda"
    rows = len(cols[0])
    host = torch.empty((len(cols), rows, n_limbs), dtype=torch.uint16, pin_memory=pinned)
    limbs = host.numpy()
    nbytes = n_limbs * LIMB_BITS // 8
    for i, col in enumerate(cols):
        raw = b"".join(v.to_bytes(nbytes, "little") for v in col)
        limbs[i] = np.frombuffer(raw, dtype="<u2").reshape(rows, n_limbs)
    profiling.count(h2d_copies=1, h2d_bytes=host.nbytes,
                    h2d_pinned_bytes=host.nbytes if pinned else 0)
    return host.to(dev, non_blocking=True).to(I32)


def constant(spec: FieldSpec, value: int, shape=(), device="cuda") -> torch.Tensor:
    dev = _cuda.require_cuda(device)
    return upload(spec.n_limbs, [[value % spec.modulus]], dev)[0, 0].expand(*shape, spec.n_limbs)


def one(spec: FieldSpec, shape=(), device="cuda") -> torch.Tensor:
    return constant(spec, 1, shape, device)


def zeros(spec: FieldSpec, shape=(), device="cuda") -> torch.Tensor:
    dev = _cuda.require_cuda(device)
    return torch.zeros((*shape, spec.n_limbs), dtype=I32, device=dev)


def pow_const(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent for a fixed non-negative exponent (kernel K2 on the card)."""
    if exponent == 0:
        return one(spec, a.shape[:-1], device=a.device).clone()
    return fc.pow_chain(spec, a, exponent)


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion a^(p-2); maps 0 -> 0."""
    return pow_const(spec, a, spec.modulus - 2)


def powers(spec: FieldSpec, x: torch.Tensor, count: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^(count-1)] of an (L,) scalar by block doubling."""
    out = one(spec, (1,), device=x.device)
    h = x.reshape(1, -1)
    m = 1
    while m < count:
        take = min(m, count - m)
        out = torch.cat([out, mul(spec, out[:take], h)], dim=0)
        m += take
        if m < count:
            h = mul(spec, h, h)
    return out


def prefix_products(spec: FieldSpec, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inclusive prefix products along ``axis`` (``scan``: log2 n steps,
    each one K1 product on the card)."""
    return scan(lambda a, b: mul(spec, a, b), x, axis)


def batch_inverse(spec: FieldSpec, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Montgomery-trick batch inversion along ``axis`` (zeros map to zero):
    two log-depth prefix scans and one Fermat inversion (kernel K2)."""
    axis = axis % x.dim()
    n = x.shape[axis]
    zero_mask = is_zero(spec, x)
    safe = torch.where(zero_mask.unsqueeze(-1), one(spec, (), device=x.device), x)

    incl_pre = prefix_products(spec, safe, axis=axis)
    incl_suf = prefix_products(spec, safe.flip(axis), axis=axis).flip(axis)
    total_inv = inv(spec, incl_pre.narrow(axis, n - 1, 1))

    ones_row = one(spec, (), device=x.device)
    pre_excl = torch.cat(
        [ones_row.expand_as(incl_pre.narrow(axis, 0, 1)), incl_pre.narrow(axis, 0, n - 1)], axis
    )
    suf_excl = torch.cat(
        [incl_suf.narrow(axis, 1, n - 1), ones_row.expand_as(incl_suf.narrow(axis, 0, 1))], axis
    )
    out = mul(spec, mul(spec, pre_excl, suf_excl), total_inv)
    return torch.where(zero_mask.unsqueeze(-1), torch.zeros_like(x), out)
