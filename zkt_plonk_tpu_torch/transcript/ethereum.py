"""EVM-compatible Fiat-Shamir transcript (byte-exact rebuild).

Behavioral spec from the reference's ``gadgets/src/transcript.rs:8-90``:
a dual Keccak-256 sponge over two 32-byte states with domain-separation
bytes 0 / 1 for absorption and 2 for challenges; challenges consume a
big-endian counter, the digest is byte-reversed and the top byte masked to
0x1f so the little-endian value always fits the BN254 scalar field.

Golden known-answer vectors from the reference tests are reproduced in
``tests/test_transcript.py``.
"""

from __future__ import annotations

from typing import Iterable

from .keccak import keccak256

_DST_0 = b"\x00"
_DST_1 = b"\x01"
_DST_CHALLENGE = b"\x02"


class EthereumTranscript:
    """Labels are accepted for API parity but ignored (as in the reference)."""

    def __init__(self, label: str = ""):
        self.state_0 = b"\x00" * 32
        self.state_1 = b"\x00" * 32
        self.counter = 0

    # -- absorption --------------------------------------------------------

    def _absorb(self, item: bytes) -> None:
        old0, old1 = self.state_0, self.state_1
        self.state_0 = keccak256(_DST_0 + old0 + old1 + item)
        self.state_1 = keccak256(_DST_1 + old0 + old1 + item)

    def append_u64(self, label: str, item: int) -> None:
        self._absorb(item.to_bytes(8, "big"))

    def append_scalar(self, label: str, item: int) -> None:
        """item: canonical field element int; absorbed as 32-byte BE."""
        self._absorb(int(item).to_bytes(32, "big"))

    def append_scalars(self, label: str, items: Iterable[int]) -> None:
        for item in items:
            self.append_scalar(label, item)

    def append_commitment(self, label: str, point) -> None:
        """point: affine (x, y) with int-convertible coords, or None.

        x then y are absorbed as 32-byte BE values (infinity absorbs zeros,
        matching arkworks' zero affine representation).
        """
        if point is None:
            x, y = 0, 0
        else:
            x, y = int(point[0]), int(point[1])
        self._absorb(x.to_bytes(32, "big"))
        self._absorb(y.to_bytes(32, "big"))

    def append_commitments(self, label: str, points) -> None:
        for pt in points:
            self.append_commitment(label, pt)

    # -- challenges --------------------------------------------------------

    def challenge_scalar(self, label: str) -> int:
        data = (
            _DST_CHALLENGE
            + self.state_0
            + self.state_1
            + self.counter.to_bytes(4, "big")
        )
        self.counter += 1
        query = bytearray(keccak256(data))
        query.reverse()
        query[31] &= 0x1F
        return int.from_bytes(bytes(query), "little")
