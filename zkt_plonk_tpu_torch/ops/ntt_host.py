"""Host (Python-int) radix-2 NTTs for SMALL domains.

For tiny circuits (n <= 512: the unit-test sizes) a host NTT on Python
ints costs less than the device launches it replaces.
``proof_system.setup`` routes its preprocessing here below
``HOST_NTT_MAX``; results are bit-identical to the device path (the same
transform over the same domains).

Mirrors ``plonk-core/src/util.rs:63-140`` (arkworks Radix2 FFT wrappers)
functionally; the device equivalents live in ``ops/ntt.py``.
"""

from __future__ import annotations

from typing import List, Sequence

HOST_NTT_MAX = 512


def _bitrev_permute(vals: List[int]) -> List[int]:
    n = len(vals)
    log_n = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        r = 0
        for b in range(log_n):
            r |= ((i >> b) & 1) << (log_n - 1 - b)
        out[r] = vals[i]
    return out


def fft_ints(coeffs: Sequence[int], omega: int, p: int) -> List[int]:
    """Natural-order coefficients -> natural-order evaluations."""
    n = len(coeffs)
    assert n & (n - 1) == 0
    x = _bitrev_permute(list(coeffs))
    size = 2
    while size <= n:
        w_step = pow(omega, n // size, p)
        half = size // 2
        for start in range(0, n, size):
            w = 1
            for k in range(half):
                lo = x[start + k]
                hi = x[start + k + half] * w % p
                x[start + k] = (lo + hi) % p
                x[start + k + half] = (lo - hi) % p
                w = w * w_step % p
        size *= 2
    return x


def ifft_ints(evals: Sequence[int], omega: int, p: int) -> List[int]:
    """Natural-order evaluations -> coefficients (uses omega^-1, 1/n)."""
    n = len(evals)
    out = fft_ints(evals, pow(omega, -1, p), p)
    n_inv = pow(n, -1, p)
    return [v * n_inv % p for v in out]


def coset_fft_ints(coeffs: Sequence[int], g: int, omega: int, p: int) -> List[int]:
    """Evaluations of the polynomial on the coset g*H."""
    scaled = []
    gi = 1
    for c in coeffs:
        scaled.append(c * gi % p)
        gi = gi * g % p
    return fft_ints(scaled, omega, p)
