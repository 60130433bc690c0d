"""Limb representation of prime-field elements at the device boundary.

A field element is an array of ``L`` 16-bit limbs, little-endian, in
CANONICAL (non-Montgomery) form: the JAX package's layout, kept here so the
two packages compare limb for limb (numpy arrays use ``uint32``, torch
tensors ``int32``).  A 16x16 product fits exactly in 32 bits; the CUDA
kernels repack the limbs into 32-bit words internally (``fields/cuda.py``).

This replaces arkworks' ``ark-ff`` Montgomery backend (+x86 ``asm`` feature,
reference ``plonk-core/Cargo.toml:65``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np

from .params import FieldParams

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(v: int, n_limbs: int) -> np.ndarray:
    out = np.zeros(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    assert v == 0, "value does not fit in limbs"
    return out


def limbs_to_int(limbs) -> int:
    v = 0
    arr = np.asarray(limbs)
    for i in range(arr.shape[-1] - 1, -1, -1):
        v = (v << LIMB_BITS) | int(arr[..., i])
    return v


def ints_to_array(values: Sequence[int], n_limbs: int) -> np.ndarray:
    """Vector of ints -> (len, L) uint32 array (bytes fast path)."""
    nbytes = n_limbs * (LIMB_BITS // 8)
    buf = b"".join(v.to_bytes(nbytes, "little") for v in values)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(values), n_limbs)
    return u16.astype(np.uint32)


def array_to_ints(arr: np.ndarray) -> list:
    """(..., L) uint32 limb array -> list of ints (bytes fast path)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1]).astype("<u2")
    nbytes = flat.shape[1] * 2
    raw = flat.tobytes()
    return [
        int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(flat.shape[0])
    ]


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Static per-field data for limb arithmetic. Hashable by identity."""

    params: FieldParams
    n_limbs: int
    modulus_limbs: np.ndarray  # (L,) uint32
    mu_limbs: np.ndarray  # (L+1,) floor(2^(32L) / p), Barrett constant

    @property
    def modulus(self) -> int:
        return self.params.modulus

    # -- host <-> device conversions (canonical form) ----------------------

    def encode(self, values: Sequence[int]) -> np.ndarray:
        """Canonical ints -> limb array (len, L)."""
        return ints_to_array(list(values), self.n_limbs)

    def decode(self, arr: np.ndarray) -> list:
        """Limb array -> canonical ints."""
        return array_to_ints(arr)

    def encode_scalar(self, v: int) -> np.ndarray:
        return int_to_limbs(v % self.modulus, self.n_limbs)

    def decode_scalar(self, arr: np.ndarray) -> int:
        return limbs_to_int(arr)

    # kept as an alias — scalars for MSM etc. are canonical already
    def encode_plain(self, values: Sequence[int]) -> np.ndarray:
        return ints_to_array(list(values), self.n_limbs)


@lru_cache(maxsize=None)
def fold_limbs(spec: "FieldSpec") -> np.ndarray:
    """Flat constant block for the fold-based modular reduction.

    Layout (all 16-bit limbs in uint32, length ``L*L + 4``):
      rows ``i*L .. i*L+L-1``: limbs of ``C_i = 2^(16*(L+i)) mod p`` — the
        fold table that reduces the high half of a double-width product by
        ``t mod p = t_lo + sum_i t_hi[i] * C_i`` (one regular L x L
        constant product instead of the (L+1) x (L+1) Barrett mu product);
      rows ``L*L .. L*L+3``: limbs of ``mu3 = floor(2^(16*(L+2)) / p)`` —
        the small-quotient Barrett constant for the folded value
        ``V < 2^(16*(L+2))``: with ``w = floor(V / 2^(16*(L-2)))`` (4
        limbs), ``qhat = floor(w * mu3 / 2^64)`` satisfies
        ``q-2 <= qhat <= q = floor(V/p)``, so two conditional
        subtractions restore canonical form.

    Every shape is a function of L alone (V fits L+2 limbs because
    ``L*2^16*p + 2^(16L) < 2^(16(L+2))`` for any L >= 2 with p using the
    top limb), so kernels need no extra static metadata.
    """
    L = spec.n_limbs
    p = spec.modulus
    rows = [(1 << (LIMB_BITS * (L + i))) % p for i in range(L)]
    # correctness guards for the bounds baked into the kernels
    v_max = (1 << (LIMB_BITS * L)) - 1 + ((1 << LIMB_BITS) - 1) * sum(rows)
    assert v_max < 1 << (LIMB_BITS * (L + 2)), "fold V exceeds L+2 limbs"
    assert v_max // p < 1 << (2 * LIMB_BITS), "fold quotient exceeds 2 limbs"
    mu3 = (1 << (LIMB_BITS * (L + 2))) // p
    assert mu3 < 1 << (4 * LIMB_BITS), "mu3 exceeds 4 limbs"
    flat = np.concatenate(
        [int_to_limbs(c, L) for c in rows] + [int_to_limbs(mu3, 4)]
    )
    return np.ascontiguousarray(flat, dtype=np.uint32)


@lru_cache(maxsize=None)
def make_spec(params: FieldParams) -> FieldSpec:
    p = params.modulus
    n_limbs = -(-p.bit_length() // LIMB_BITS)
    # word-aligned Barrett precondition: p uses the top limb
    assert p >= 1 << (LIMB_BITS * (n_limbs - 1))
    mu = (1 << (2 * LIMB_BITS * n_limbs)) // p
    return FieldSpec(
        params=params,
        n_limbs=n_limbs,
        modulus_limbs=int_to_limbs(p, n_limbs),
        mu_limbs=int_to_limbs(mu, n_limbs + 1),
    )
