"""Merlin transcript (STROBE-128 over Keccak-f[1600]) — byte-exact.

The reference's default transcript (``plonk-core/src/transcript.rs:49-109``
wraps the ``merlin`` crate).  This is a from-scratch STROBE-128
implementation following the STROBE v1.0.2 spec as instantiated by Merlin
("Merlin v1.0" protocol label, dom-sep framing, LE32 length framing);
validated against merlin's published conformance vector.

Scalar/commitment encodings follow arkworks ``ToBytes``: field elements as
little-endian canonical bytes; affine points as x || y || infinity-byte.
"""

from __future__ import annotations

from typing import Iterable

from .keccak import keccak_f1600

_R = 166  # STROBE-128 rate for keccak-f[1600]
_FLAG_I = 1
_FLAG_A = 2
_FLAG_C = 4
_FLAG_T = 8
_FLAG_M = 16
_FLAG_K = 32


def _bytes_to_lanes(state: bytes):
    lanes = [[0] * 5 for _ in range(5)]
    for i in range(25):
        x, y = i % 5, i // 5
        lanes[x][y] = int.from_bytes(state[8 * i : 8 * i + 8], "little")
    return lanes


def _lanes_to_bytes(lanes) -> bytearray:
    out = bytearray(200)
    for i in range(25):
        x, y = i % 5, i // 5
        out[8 * i : 8 * i + 8] = lanes[x][y].to_bytes(8, "little")
    return out


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = _lanes_to_bytes(keccak_f1600(_bytes_to_lanes(bytes(st))))
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals ---------------------------------------------------------

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        self.state = _lanes_to_bytes(keccak_f1600(_bytes_to_lanes(bytes(self.state))))
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert flags == self.cur_flags
            return
        assert flags & _FLAG_T == 0, "transport not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_FLAG_C | _FLAG_K) and self.pos != 0:
            self._run_f()

    # -- operations --------------------------------------------------------

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)


class MerlinTranscript:
    """Drop-in transcript with the prover/verifier interface
    (labels ARE significant, unlike the Ethereum transcript).

    ``coord_bytes`` is the fixed serialized width of an affine point
    coordinate (arkworks CanonicalSerialize is field-sized): 32 covers
    BN254; pass 48 for BLS12-381 (e.g. ``transcript_factory=lambda
    label: MerlinTranscript(label, coord_bytes=48)``)."""

    def __init__(self, label: str = "", coord_bytes: int = 32):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.coord_bytes = coord_bytes
        self._append_message(b"dom-sep", label.encode())

    def _append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label + len(message).to_bytes(4, "little"), False)
        self.strobe.ad(message, False)

    def _challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label + n.to_bytes(4, "little"), False)
        return self.strobe.prf(n, False)

    # -- protocol interface ------------------------------------------------

    def append_u64(self, label: str, item: int):
        self._append_message(label.encode(), item.to_bytes(8, "little"))

    def append_scalar(self, label: str, item: int):
        self._append_message(label.encode(), int(item).to_bytes(32, "little"))

    def append_scalars(self, label: str, items: Iterable[int]):
        data = b"".join(int(v).to_bytes(32, "little") for v in items)
        self._append_message(label.encode(), data)

    def _point_bytes(self, point) -> bytes:
        w = self.coord_bytes
        if point is None:
            return (0).to_bytes(2 * w, "little") + b"\x01"
        return (
            int(point[0]).to_bytes(w, "little")
            + int(point[1]).to_bytes(w, "little")
            + b"\x00"
        )

    def append_commitment(self, label: str, point):
        self._append_message(label.encode(), self._point_bytes(point))

    def append_commitments(self, label: str, points):
        data = b"".join(self._point_bytes(pt) for pt in points)
        self._append_message(label.encode(), data)

    def challenge_scalar(self, label: str, num_bytes: int = 31) -> int:
        """(size_in_bits/8 - 1) bytes, LE — ``transcript.rs:102-108``."""
        raw = self._challenge_bytes(label.encode(), num_bytes)
        return int.from_bytes(raw, "little")


def make(label: str, coord_bytes: int) -> MerlinTranscript:
    """The transcript a configuration names ``merlin`` (``plonk_kzg``
    finds it by that name)."""
    return MerlinTranscript(label, coord_bytes=coord_bytes)
