"""Field kernels K1 (``fp_binop``) and K2 (``fp_pow_chain``) and their plain
PyTorch versions — the counterpart of ``zkt_plonk_tpu/fields/pallas.py``.

Layout at the boundary: canonical 16-bit limbs in the last axis,
``(..., L)`` ``torch.int32``.  A wrapper launches its CUDA kernel
(``csrc/fp_binop.cu``, ``csrc/fp_pow_chain.cu``) for tensors on the card and
runs its plain version for tensors on the CPU; tensors on two devices, or a
wrong dtype or limb count, raise.

The plain versions do their limb arithmetic in ``torch.int64`` (torch's CPU
``uint32`` has no ``+``, ``>>`` or comparisons).  A product is the
schoolbook column sums of the limb products (< 2^40), the high half
folded into the low half with C_i = 2^(16(L+i)) mod p (columns < 2^60),
a float64 estimate of the quotient by p (off by at most one), one
subtraction of q*p and one final correction by +-p.  Carries are resolved by
a sequential pass over the limbs, vectorized over the elements.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import _cuda
from .limbs import LIMB_BITS, LIMB_MASK, FieldSpec

OPS = {"mul": 0, "add": 1, "sub": 2}


# ---------------------------------------------------------------------------
# plain int64 limb arithmetic (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _consts64(spec: FieldSpec, device: torch.device):
    L = spec.n_limbs
    p = spec.modulus
    p_limbs = torch.tensor(
        [(p >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)], dtype=torch.int64, device=device
    )
    fold = torch.tensor(
        [
            [((1 << (LIMB_BITS * (L + i))) % p >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)]
            for i in range(L - 1)
        ],
        dtype=torch.int64,
        device=device,
    )
    scale = torch.tensor(
        [float(1 << (LIMB_BITS * j)) for j in range(L)], dtype=torch.float64, device=device
    )
    return p_limbs, fold, scale, float(p)


def carry(cols: torch.Tensor):
    """Signed int64 columns (..., K) -> (limbs in [0, 2^16), carry out c)
    with value = sum_j limbs_j 2^(16j) + c 2^(16K).  Runs limb-major (one
    contiguous row per limb, updated in place) and returns a view."""
    rows = cols.movedim(-1, 0).contiguous()
    c = torch.zeros_like(rows[0])
    for j in range(rows.shape[0]):
        row = rows[j]
        row.add_(c)
        c = row >> LIMB_BITS
        row.bitwise_and_(LIMB_MASK)
    return rows.movedim(0, -1), c


def column_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the limb product of (..., R) and (..., C):
    out[k] = sum_{i+j=k} a[i] b[j], shape (..., R+C-1)."""
    R, C = a.shape[-1], b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros((*batch, R + C - 1), dtype=torch.int64, device=a.device)
    for i in range(R):
        out[..., i : i + C] += a[..., i : i + 1] * b
    return out


def add64(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p_limbs = _consts64(spec, a.device)[0]
    s = a + b
    limbs, c = carry(torch.stack(torch.broadcast_tensors(s, s - p_limbs)))
    return torch.where((c[1] >= 0).unsqueeze(-1), limbs[1], limbs[0])


def sub64(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p_limbs = _consts64(spec, a.device)[0]
    d = a - b
    limbs, c = carry(torch.stack(torch.broadcast_tensors(d, d + p_limbs)))
    return torch.where((c[0] >= 0).unsqueeze(-1), limbs[0], limbs[1])


def mul64(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p, canonical out, for non-negative limbs below 2^18 (canonical
    values or a few of them added unreduced): columns stay below 2^40, the
    folded ones below 2^60, and the float64 quotient estimate (q < 2^47,
    relative error < 2^-48) is off by at most one."""
    L = spec.n_limbs
    p_limbs, fold, scale, p_f = _consts64(spec, a.device)
    a, b = torch.broadcast_tensors(a, b)
    cols = column_sums(a, b)  # (..., 2L-1) < 2^40
    V = cols[..., :L] + (cols[..., L:].unsqueeze(-1) * fold).sum(-2)  # < 2^60
    q = torch.floor((V.to(torch.float64) * scale).sum(-1) / p_f).to(torch.int64)
    qs = torch.stack([q & LIMB_MASK, (q >> LIMB_BITS) & LIMB_MASK, q >> (2 * LIMB_BITS)], -1)
    qp = column_sums(qs, p_limbs)  # (..., L+2)
    r, c = carry(F.pad(V, (0, 2)) - qp)  # r = V - q p in [-p, 2p)
    r = r[..., :L]
    limbs, c2 = carry(torch.stack([r + p_limbs, r - p_limbs]))
    keep_sub = (c2[1] >= 0).unsqueeze(-1)
    return torch.where((c < 0).unsqueeze(-1), limbs[0], torch.where(keep_sub, limbs[1], r))


def binop_plain(spec: FieldSpec, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1 (int64 limb math); int32 in and out."""
    fn = {"mul": mul64, "add": add64, "sub": sub64}[op]
    return fn(spec, a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


POW_MAX_WINDOW = 5  # csrc/fp_pow_chain.cu holds odd powers up to x^31


class PowSchedule(NamedTuple):
    """A left-to-right sliding-window chain for a^e: the table holds the odd
    powers a^(2i+1), i < ``ntab``; the chain starts at table entry
    ``first`` and, for each (squarings, index) of ``steps``, squares that
    many times and multiplies by the entry; then squares ``tail`` times."""

    window: int
    ntab: int
    first: int
    steps: Tuple[Tuple[int, int], ...]
    tail: int

    def products(self) -> int:
        """Modular products of the chain, the table's included."""
        table = self.ntab if self.ntab > 1 else 0  # a^2, then ntab - 1 multiplies
        return table + sum(s + 1 for s, _ in self.steps) + self.tail


def _sliding_window(exponent: int, window: int) -> PowSchedule:
    bits = bin(exponent)[2:]
    n = len(bits)

    def digit(i):
        # the window starting at the 1 at bit string index i: up to ``window``
        # bits, ending in a 1
        j = min(i + window, n)
        while bits[j - 1] == "0":
            j -= 1
        return int(bits[i:j], 2), j

    d, i = digit(0)
    first, top = d >> 1, d
    steps = []
    while True:
        z = i
        while z < n and bits[z] == "0":
            z += 1
        if z == n:
            tail = n - i
            break
        d, j = digit(z)
        steps.append((j - i, d >> 1))
        top = max(top, d)
        i = j
    return PowSchedule(window, top // 2 + 1, first, tuple(steps), tail)


@lru_cache(maxsize=None)
def window_schedule(exponent: int) -> PowSchedule:
    """The sliding-window chain of fewest products for windows of 1 to 5
    bits (the smaller window on a tie)."""
    if exponent < 1:
        raise ValueError("pow_chain needs an exponent >= 1")
    return min(
        (_sliding_window(exponent, w) for w in range(1, POW_MAX_WINDOW + 1)),
        key=lambda s: s.products(),
    )


def pow_chain_plain(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """The plain PyTorch version of K2: the same sliding-window chain."""
    sched = window_schedule(exponent)
    x = a.to(torch.int64)
    tab = [x]
    if sched.ntab > 1:
        x2 = mul64(spec, x, x)
        for _ in range(sched.ntab - 1):
            tab.append(mul64(spec, tab[-1], x2))
    acc = tab[sched.first]
    for squarings, idx in sched.steps:
        for _ in range(squarings):
            acc = mul64(spec, acc, acc)
        acc = mul64(spec, acc, tab[idx])
    for _ in range(sched.tail):
        acc = mul64(spec, acc, acc)
    return acc.to(torch.int32)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_operand(spec: FieldSpec, t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 limbs, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != spec.n_limbs:
        raise ValueError(f"{name}: expected (..., {spec.n_limbs}) limbs, got {tuple(t.shape)}")


def kernel_ready(t: torch.Tensor, elem_dims: int) -> torch.Tensor:
    """A view the kernels accept as is: trailing element dims contiguous,
    outer strides whole elements, 16-byte aligned; otherwise a copy."""
    esize = 1
    ok = True
    for d in range(1, elem_dims + 1):
        if t.shape[-d] != 1 and t.stride(-d) != esize:
            ok = False
        esize *= t.shape[-d]
    ok = ok and all(t.stride(d) % esize == 0 for d in range(t.dim() - elem_dims))
    ok = ok and t.data_ptr() % 16 == 0
    return t if ok else t.contiguous()


def binop(spec: FieldSpec, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise ``op`` in {"mul", "add", "sub"} mod p with broadcasting."""
    _check_operand(spec, a, "a")
    _check_operand(spec, b, "b")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return binop_plain(spec, op, a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"operands on {a.device} and {b.device}")
    L = spec.n_limbs
    a = kernel_ready(a, 1)
    b = kernel_ready(b, 1)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n == 0:
        return out
    meta = _cuda.broadcast_meta(shape, a, b, 1)
    fn = _cuda.lib("fp_binop").zk_fp_binop
    err = fn(
        L, OPS[op], a.data_ptr(), b.data_ptr(), out.data_ptr(), n, len(meta),
        _cuda.ll_array([m[0] for m in meta]),
        _cuda.ll_array([m[1] for m in meta]),
        _cuda.ll_array([m[2] for m in meta]),
        _cuda.field_consts(spec), _cuda.stream_ptr(a),
    )
    _cuda.check(err, "fp_binop")
    _cuda.count(_cuda.instance("fp_binop", L))
    return out


def pow_chain(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent elementwise for a fixed exponent >= 1; maps 0 to 0.  On
    the card the kernel runs lazily (values below 2p) where 4p < R and in
    its strict mode (values below p) where only 2p < R (BLS12-381's Fr);
    at L = 24 (the BLS12 base fields, 4p < R) lazily only."""
    _check_operand(spec, a, "a")
    if exponent < 1:
        raise ValueError("pow_chain needs an exponent >= 1")
    if a.device.type == "cpu":
        return pow_chain_plain(spec, a, exponent)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if exponent.bit_length() > 512:
        raise ValueError("exponent above 512 bits")
    sched = window_schedule(exponent)
    strict, consts = _cuda.reduction_consts(spec)
    a = a.contiguous()
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    nsteps = len(sched.steps)
    fn = _cuda.lib("fp_pow_chain").zk_fp_pow_chain
    err = fn(
        spec.n_limbs, a.data_ptr(), out.data_ptr(), a.numel() // spec.n_limbs,
        sched.ntab, sched.first, nsteps, sched.tail,
        (_cuda.ctypes.c_ushort * max(1, nsteps))(*[s for s, _ in sched.steps]),
        (_cuda.ctypes.c_ubyte * max(1, nsteps))(*[d for _, d in sched.steps]),
        int(strict), consts, _cuda.stream_ptr(a),
    )
    key = _cuda.instance("fp_pow_chain", spec.n_limbs, strict=strict)
    _cuda.check(err, key)
    _cuda.count(key)
    return out
