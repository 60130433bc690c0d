"""Host-side prime field elements (Python ints).

Used for circuit construction, witness synthesis, transcripts and the
verifier — everything that is control-flow heavy and tiny.  The device
path operates on limb tensors instead (see ``fields/device.py``).

Functional equivalent of arkworks ``ark-ff`` field ops used throughout the
reference (e.g. ``plonk-core/src/constraint_system``); the
design is host-idiomatic Python rather than a trait hierarchy.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterable, List, Union

from .params import FieldParams


class FpElement:
    """A prime field element. Immutable; value stored as canonical int."""

    __slots__ = ("v",)

    # Subclasses bind these.
    params: FieldParams = None  # type: ignore
    p: int = 0

    def __init__(self, v: Union[int, "FpElement"]):
        if isinstance(v, FpElement):
            v = v.v
        self.v = v % self.p

    # -- constructors ------------------------------------------------------
    @classmethod
    def zero(cls) -> "FpElement":
        return cls(0)

    @classmethod
    def one(cls) -> "FpElement":
        return cls(1)

    @classmethod
    def from_le_bytes(cls, data: bytes) -> "FpElement":
        v = int.from_bytes(data, "little")
        if v >= cls.p:
            raise ValueError("non-canonical field repr")
        return cls(v)

    @classmethod
    def from_be_bytes(cls, data: bytes) -> "FpElement":
        v = int.from_bytes(data, "big")
        if v >= cls.p:
            raise ValueError("non-canonical field repr")
        return cls(v)

    @classmethod
    def rand(cls, rng) -> "FpElement":
        """Uniform random element; rng is a ``random.Random``-like object."""
        return cls(rng.getrandbits(cls.p.bit_length() + 64))

    # -- serialization -----------------------------------------------------
    def to_le_bytes(self) -> bytes:
        return self.v.to_bytes(self.params.bytes_len, "little")

    def to_be_bytes(self) -> bytes:
        return self.v.to_bytes(self.params.bytes_len, "big")

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return type(self)(self.v - _val(o))

    def __rsub__(self, o):
        return type(self)(_val(o) - self.v)

    def __mul__(self, o):
        return type(self)(self.v * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.v)

    def __truediv__(self, o):
        return self * type(self)(o).inverse()

    def __rtruediv__(self, o):
        return type(self)(o) * self.inverse()

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.p))

    def square(self):
        return type(self)(self.v * self.v)

    def double(self):
        return type(self)(self.v << 1)

    def inverse(self) -> "FpElement":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero field element")
        return type(self)(pow(self.v, -1, self.p))

    def inverse_or_zero(self) -> "FpElement":
        return self.zero() if self.v == 0 else self.inverse()

    def sqrt(self):
        """Square root (Tonelli-Shanks); returns None if non-residue."""
        r = sqrt_mod(self.v, self.p)
        return None if r is None else type(self)(r)

    # -- predicates / misc -------------------------------------------------
    def is_zero(self) -> bool:
        return self.v == 0

    def is_one(self) -> bool:
        return self.v == 1

    def __eq__(self, o):
        if isinstance(o, FpElement):
            return self.p == o.p and self.v == o.v
        if isinstance(o, int):
            return self.v == o % self.p
        return NotImplemented

    def __hash__(self):
        return hash((self.p, self.v))

    def __int__(self):
        return self.v

    def __repr__(self):
        return f"{self.params.name}({self.v})"


def _val(o) -> int:
    return o.v if isinstance(o, FpElement) else int(o)


@lru_cache(maxsize=None)
def make_field(params: FieldParams):
    """Create (and cache) a field element class bound to ``params``."""

    cls = type(
        f"F_{params.name}",
        (FpElement,),
        {"params": params, "p": params.modulus, "__slots__": ()},
    )
    return cls


def sqrt_mod(a: int, p: int):
    """Tonelli-Shanks modular square root; None if ``a`` is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general case
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def batch_inverse_ints(values: List[int], p: int) -> List[int]:
    """Montgomery batch inversion on canonical ints (zeros map to zero)."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * (v if v != 0 else 1) % p
    inv = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = values[i]
        if v == 0:
            continue
        out[i] = inv * prefix[i] % p
        inv = inv * v % p
    return out


def powers_of(x: FpElement, n: int) -> List[FpElement]:
    """[1, x, x^2, ..., x^(n-1)] — mirrors util.rs:19-24 powers_of."""
    out = [type(x).one()]
    for _ in range(n - 1):
        out.append(out[-1] * x)
    return out
