"""arkworks ``CanonicalSerialize`` (v0.3) compatible byte encodings.

The reference pins ark-serialize 0.3 (``plonk-core/Cargo.toml``) and
serializes key/proof artifacts with it: the derived ``Proof`` serializer
(``proof.rs:98``) and the CLI file checkpoints (``bin/src/parser.rs:5-23``,
which use the *_unchecked = uncompressed-no-validation variants).

Format rules implemented here (ark-serialize 0.3 / ark-ec 0.3):

* Field elements: canonical (non-Montgomery) integer, little-endian, in
  ``ceil(MODULUS_BITS / 8)`` bytes; flags (when present) are OR-ed into
  the MOST significant bits of the LAST byte (2 flag bits must fit in the
  byte-size slack, true for all three supported curves' Fq).
* Short-Weierstrass points, compressed (= ``serialize``): the x
  coordinate with SWFlags — ``Infinity -> 1 << 6``, ``PositiveY ->
  1 << 7``, ``NegativeY -> no bits`` — where "positive" means
  ``y > -y`` as integers, i.e. y > (p-1)/2 (ark-ec 0.3
  ``short_weierstrass_jacobian.rs`` serialize + ark-serialize 0.3
  ``flags.rs``).  Infinity serializes a zero x.
* Uncompressed (= ``serialize_uncompressed`` / ``*_unchecked``): x with
  no flags, then y with SWFlags (infinity bit only relevant).
* ``Option<T>``: one byte 0/1 then the value (KZG10 opening proofs carry
  ``random_v: Option<F>`` = None without hiding).
* The Proof layout follows the field declaration order of ``proof.rs:
  106-155``: 11 commitments, aw/saw openings, then the 12 evaluations in
  WireEvaluations/PermutationEvaluations/LookupEvaluations order.

NOTE on provenance: this environment has no Rust toolchain, so the golden
fixtures in ``tests/test_arkserde.py`` are self-generated regression
anchors; the flag-bit conventions above are transcribed from the
ark-serialize 0.3 sources.  A one-time cross-check against a Rust-built
artifact is still advisable when a cargo environment is available.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Point = Optional[Tuple[int, int]]

SW_INFINITY = 1 << 6
SW_POSITIVE_Y = 1 << 7


def field_byte_size(modulus: int) -> int:
    return (modulus.bit_length() + 7) // 8


def fp_to_bytes(value: int, modulus: int, flags: int = 0) -> bytes:
    nbytes = field_byte_size(modulus)
    if flags:
        assert modulus.bit_length() + 2 <= 8 * nbytes, "flags don't fit"
    raw = bytearray(int(value % modulus).to_bytes(nbytes, "little"))
    raw[-1] |= flags
    return bytes(raw)


def fp_from_bytes(data: bytes, modulus: int, with_flags: bool = False):
    nbytes = field_byte_size(modulus)
    assert len(data) == nbytes, f"expected {nbytes} bytes, got {len(data)}"
    raw = bytearray(data)
    flags = 0
    if with_flags:
        flags = raw[-1] & 0b1100_0000
        raw[-1] &= 0b0011_1111
    value = int.from_bytes(bytes(raw), "little")
    assert value < modulus, "non-canonical field element"
    return (value, flags) if with_flags else value


def _y_is_positive(y: int, p: int) -> bool:
    """ark-ec 0.3 sign convention: positive iff y > -y (as integers)."""
    return y > p - y


def g1_to_bytes_compressed(pt: Point, fq_modulus: int) -> bytes:
    if pt is None:
        return fp_to_bytes(0, fq_modulus, SW_INFINITY)
    x, y = int(pt[0]), int(pt[1])
    flags = SW_POSITIVE_Y if _y_is_positive(y, fq_modulus) else 0
    return fp_to_bytes(x, fq_modulus, flags)


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """Modular square root (None if a is a non-residue).

    p % 4 == 3 fast path (BN254, BLS12-381 Fq); Tonelli-Shanks otherwise
    (BLS12-377 Fq has p % 4 == 1).
    """
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def g1_from_bytes_compressed(data: bytes, fq_modulus: int, curve_b: int) -> Point:
    """Decompress x + flags -> affine point (validates curve membership)."""
    x, flags = fp_from_bytes(data, fq_modulus, with_flags=True)
    if flags & SW_INFINITY:
        return None
    p = fq_modulus
    rhs = (pow(x, 3, p) + curve_b) % p
    y = sqrt_mod(rhs, p)
    assert y is not None, "x is not on the curve"
    want_positive = bool(flags & SW_POSITIVE_Y)
    if _y_is_positive(y, p) != want_positive:
        y = (p - y) % p
    return (x, y)


def g1_to_bytes_uncompressed(pt: Point, fq_modulus: int) -> bytes:
    if pt is None:
        return fp_to_bytes(0, fq_modulus) + fp_to_bytes(0, fq_modulus, SW_INFINITY)
    return fp_to_bytes(int(pt[0]), fq_modulus) + fp_to_bytes(int(pt[1]), fq_modulus)


def g1_from_bytes_uncompressed(data: bytes, fq_modulus: int) -> Point:
    nb = field_byte_size(fq_modulus)
    x = fp_from_bytes(data[:nb], fq_modulus)
    y, flags = fp_from_bytes(data[nb:], fq_modulus, with_flags=True)
    if flags & SW_INFINITY:
        return None
    return (x, y)


# ---------------------------------------------------------------------------
# Proof <-> bytes (KZG instantiation)
# ---------------------------------------------------------------------------

_COMMIT_ORDER = [
    "a_commit", "b_commit", "c_commit", "t_commit", "h1_commit", "h2_commit",
    "z1_commit", "z2_commit", "q_lo_commit", "q_mid_commit", "q_hi_commit",
]
_EVAL_ORDER = [
    "a", "b", "c",  # WireEvaluations (proof.rs:32-38)
    "sigma1", "sigma2", "z1_next",  # PermutationEvaluations (:46-53)
    "q_lookup", "t", "t_next", "z2_next", "h1_next", "h2",  # Lookup (:60-78)
]


def proof_to_bytes(proof, fq_modulus: int, fr_modulus: int) -> bytes:
    """KZG Proof -> ark-canonical bytes (compressed commitments).

    Openings follow ark-poly-commit 0.3 ``kzg10::Proof``: the witness
    point compressed, then ``random_v: Option<F>`` (None -> 0x00).
    """
    out = bytearray()
    for name in _COMMIT_ORDER:
        out += g1_to_bytes_compressed(getattr(proof, name), fq_modulus)
    for opening in (proof.aw_opening, proof.saw_opening):
        out += g1_to_bytes_compressed(opening, fq_modulus)
        out += b"\x00"  # random_v: None
    for name in _EVAL_ORDER:
        out += fp_to_bytes(getattr(proof.evaluations, name), fr_modulus)
    return bytes(out)


def proof_from_bytes(data: bytes, fq_modulus: int, fr_modulus: int, curve_b: int):
    from ..proof_system.proof import Proof, ProofEvaluations

    nq = field_byte_size(fq_modulus)
    nr = field_byte_size(fr_modulus)
    off = 0
    fields = {}
    for name in _COMMIT_ORDER:
        fields[name] = g1_from_bytes_compressed(data[off : off + nq], fq_modulus, curve_b)
        off += nq
    openings = []
    for _ in range(2):
        openings.append(
            g1_from_bytes_compressed(data[off : off + nq], fq_modulus, curve_b)
        )
        off += nq
        assert data[off] == 0, "hiding openings not supported"
        off += 1
    evals = {}
    for name in _EVAL_ORDER:
        evals[name] = fp_from_bytes(data[off : off + nr], fr_modulus)
        off += nr
    assert off == len(data), "trailing bytes in proof"
    return Proof(
        aw_opening=openings[0],
        saw_opening=openings[1],
        evaluations=ProofEvaluations(**evals),
        **fields,
    )
