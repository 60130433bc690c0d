"""Poseidon parameter generation + baked BN254 instances.

Rebuild of ``plonk-hashing/src/hasher/poseidon/{constants.rs,
round_numbers.rs, round_constant.rs, mds.rs}`` (neptune-derived):

* round-number search at M=128 security for 256-bit primes;
* Grain-LFSR round-constant sampling with rejection;
* Cauchy-style MDS matrix (entries 1/(x_i + y_j)).

The audited BN254 width-3/4/5 instances are loaded from a JSON data file
extracted from the reference's hex blobs (``gadgets/src/poseidon/bn254_x*.rs``,
including its skip-2-hex-chars little-endian parsing — see
``scripts/extract_poseidon_constants.py``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np

_M_SECURITY = 128
_PRIME_BITLEN = 256


@dataclass(frozen=True)
class PoseidonConstants:
    p: int
    width: int
    mds: tuple  # width x width tuple of tuples (ints)
    round_constants: tuple  # ints
    domain_tag: int
    full_rounds: int
    half_full_rounds: int
    partial_rounds: int

    @staticmethod
    def from_constants(p, width, full_rounds, partial_rounds, mds, round_constants):
        assert full_rounds % 2 == 0
        assert width * (full_rounds + partial_rounds) <= len(round_constants)
        arity = width - 1
        return PoseidonConstants(
            p=p,
            width=width,
            mds=tuple(tuple(row) for row in mds),
            round_constants=tuple(round_constants),
            domain_tag=(1 << arity) - 1,
            full_rounds=full_rounds,
            half_full_rounds=full_rounds // 2,
            partial_rounds=partial_rounds,
        )

    @staticmethod
    def generate(p: int, width: int, field_bits: int) -> "PoseidonConstants":
        full, partial = calc_round_numbers(width, security_margin=True)
        mds = generate_mds(p, width)
        rcs = generate_round_constants(p, field_bits, width, full, partial)
        return PoseidonConstants.from_constants(p, width, full, partial, mds, rcs)


# ---------------------------------------------------------------------------
# round numbers (``round_numbers.rs:50-98``; f32 arithmetic replicated)
# ---------------------------------------------------------------------------


def _round_numbers_are_secure(t: int, rf: int, rp: int) -> bool:
    f = np.float32
    rp_f, t_f, n, m = f(rp), f(t), f(_PRIME_BITLEN), f(_M_SECURITY)
    rf_stat = f(6.0) if m <= (n - f(3.0)) * (t_f + f(1.0)) else f(10.0)
    rf_interp = f(0.43) * m + np.log2(t_f) - rp_f
    rf_grob_1 = f(0.21) * n - rp_f
    rf_grob_2 = (f(0.14) * n - f(1.0) - rp_f) / (t_f - f(1.0))
    rf_max = max(int(np.ceil(v)) for v in (rf_stat, rf_interp, rf_grob_1, rf_grob_2))
    return rf >= rf_max


def calc_round_numbers(t: int, security_margin: bool) -> tuple:
    rf, rp = 0, 0
    n_sboxes_min = float("inf")
    for rf_test in range(2, 1001, 2):
        for rp_test in range(4, 200):
            if _round_numbers_are_secure(t, rf_test, rp_test):
                rft, rpt = rf_test, rp_test
                if security_margin:
                    rft += 2
                    rpt = int(np.ceil(np.float32(1.075) * np.float32(rp_test)))
                n_sboxes = t * rft + rpt
                if n_sboxes < n_sboxes_min or (n_sboxes == n_sboxes_min and rft < rf):
                    rf, rp = rft, rpt
                    n_sboxes_min = n_sboxes
    return rf, rp


# ---------------------------------------------------------------------------
# Grain LFSR round constants (``round_constant.rs``)
# ---------------------------------------------------------------------------


class _GrainLFSR:
    def __init__(self, init_bits: List[int], field_size: int):
        assert len(init_bits) == 80
        self.state = list(init_bits)
        self.field_size = field_size
        for _ in range(160):
            self._gen()

    def _gen(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def _next_filtered(self) -> int:
        # pairs (b1, b2): emit b2 when b1 == 1, else discard
        b = self._gen()
        while not b:
            self._gen()
            b = self._gen()
        return self._gen()

    def _next_byte(self, bits: int) -> int:
        acc = 0
        for _ in range(bits):
            acc = (acc << 1) | self._next_filtered()
        return acc

    def next_field_bytes(self, n_bytes: int) -> bytes:
        rem = self.field_size % 8
        out = [self._next_byte(rem if rem > 0 else 8)]
        for _ in range(n_bytes - 1):
            out.append(self._next_byte(8))
        return bytes(out)


def _append_bits(bits: List[int], n: int, value: int):
    for i in range(n - 1, -1, -1):
        bits.append((value >> i) & 1)


def generate_round_constants(
    p: int, field_bits: int, t: int, r_f: int, r_p: int
) -> List[int]:
    n_bytes = (field_bits + 7) // 8
    assert n_bytes == 32, "32-byte fields only (as the reference)"
    num_constants = (r_f + r_p) * t

    bits: List[int] = []
    _append_bits(bits, 2, 1)  # prime field
    _append_bits(bits, 4, 1)  # x^5 sbox
    _append_bits(bits, 12, field_bits)
    _append_bits(bits, 12, t)
    _append_bits(bits, 10, r_f)
    _append_bits(bits, 10, r_p)
    _append_bits(bits, 30, (1 << 30) - 1)
    grain = _GrainLFSR(bits, field_bits)

    out = []
    while len(out) < num_constants:
        raw = grain.next_field_bytes(n_bytes)  # big-endian-ish draw
        v = int.from_bytes(raw[::-1], "little")  # reference reverses to LE
        # reversed big-endian == big-endian int; from_random_bytes rejects >= p
        if v < p:
            out.append(v)
    return out


# ---------------------------------------------------------------------------
# MDS (``mds.rs:43-64``)
# ---------------------------------------------------------------------------


def generate_mds(p: int, t: int) -> List[List[int]]:
    return [[pow((x + y) % p, -1, p) for y in range(t, 2 * t)] for x in range(t)]


# ---------------------------------------------------------------------------
# baked BN254 instances
# ---------------------------------------------------------------------------

BN254_FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

_DATA_PATH = os.path.join(os.path.dirname(__file__), "bn254_constants.json")


@lru_cache(maxsize=None)
def bn254_constants(width: int) -> PoseidonConstants:
    """Audited BN254 Poseidon instance for width 3, 4 or 5."""
    with open(_DATA_PATH) as f:
        data = json.load(f)[str(width)]
    return PoseidonConstants.from_constants(
        p=BN254_FR_MODULUS,
        width=width,
        full_rounds=data["full_rounds"],
        partial_rounds=data["partial_rounds"],
        mds=[[int(v) for v in row] for row in data["mds"]],
        round_constants=[int(v) for v in data["round_constants"]],
    )
