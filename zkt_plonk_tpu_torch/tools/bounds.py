"""The least time an H100 could take for a kernel's work, for chip_smoke.py
and the timing tools.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate,
and the 32-bit integer multiplies it must do over the card's peak rate for
them.  Only what the function needs is counted, not a kernel's own
bookkeeping (Montgomery conversions).
"""

from __future__ import annotations

import torch

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet) and 32-bit integer
# multiplies at 132 SMs x 64 lanes x 1.98 GHz = 16.7 T/s (the INT32 lanes
# are half the FP32 lanes behind the 67 TFLOP/s float32 peak).
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9

# 32-bit multiplies of 256-bit field arithmetic: a product is 8x8 word
# products, each a mul.lo and a mul.hi; a Montgomery reduction is 8
# quotient words (a mul.lo each) and 8x8 word products of them with p.  A
# modular product is one of each; a complete EC add (RCB Algorithm 7, a = 0,
# 3b by additions) needs 12 products and 9 reductions, since layer 3 sums
# its products in pairs before one reduction (csrc/ec.cuh); a mixed add
# (Algorithm 8, Z2 = 1) 11 products and 8 reductions.
PRODUCT_OPS = 2 * 8 * 8
REDUCE_OPS = 8 + 2 * 8 * 8
MODMUL_OPS = PRODUCT_OPS + REDUCE_OPS
EC_ADD_OPS = 12 * PRODUCT_OPS + 9 * REDUCE_OPS
EC_MIXED_OPS = 11 * PRODUCT_OPS + 8 * REDUCE_OPS
# the same at 12 words (L = 24, the BLS12 base fields)
MODMUL_OPS_24 = 2 * 12 * 12 + 12 + 2 * 12 * 12
EC_ADD_OPS_24 = 12 * (2 * 12 * 12) + 9 * (12 + 2 * 12 * 12)
EC_MIXED_OPS_24 = 11 * (2 * 12 * 12) + 8 * (12 + 2 * 12 * 12)


def bound_ms(nbytes: float, int_ops: float):
    """(milliseconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# K4a, the MSM's bucket accumulation (ops/msm.py bucket_accumulate)
# ---------------------------------------------------------------------------


def step_counts(digits: torch.Tensor, n: int, G: int, K: int):
    """(first hits, repeat hits, padding steps into a bucket already hit)
    over the rows of these (BW, n_pad) digit codes: what K4a computes, two,
    eleven (with eight reductions) and three products each."""
    BW, n_pad = digits.shape
    S = n_pad // G
    dev = digits.device
    codes = digits.to(torch.int64)
    mags = torch.where(codes < 0, ~codes, codes).reshape(BW, S, G).transpose(1, 2)  # (BW, G, S)
    real = (torch.arange(S, device=dev)[None, :] * G + torch.arange(G, device=dev)[:, None]) < n
    hit = torch.zeros((BW, G, K + 1), dtype=torch.bool, device=dev)
    hit.scatter_(2, torch.where(real[None], mags, K), True)  # column K: the padding
    first = int(hit[..., :K].sum())
    repeat = int(real.sum()) * BW - first
    padding = int((hit.gather(2, mags) & ~real[None]).sum())
    return first, repeat, padding


def accumulate_bound(digits: torch.Tensor, n: int, G: int, K: int, L: int = 16):
    """K4a at L limbs: the work these digits need.  The points read once (x
    and y, 2 x 2L bytes each), the digits read once and the bucket tensor
    written once; the products of the step counts."""
    BW, n_pad = digits.shape
    mixed, modmul = (EC_MIXED_OPS_24, MODMUL_OPS_24) if L == 24 else (EC_MIXED_OPS, MODMUL_OPS)
    first, repeat, padding = step_counts(digits, n, G, K)
    nbytes = 2 * 2 * L * n + 2 * BW * n_pad + 3 * 4 * L * G * BW * K
    ops = repeat * mixed + first * 2 * modmul + padding * 3 * modmul
    return bound_ms(nbytes, ops)


# ---------------------------------------------------------------------------
# K5, the MSM's digit recoding (ops/msm.py digit_rows)
# ---------------------------------------------------------------------------


def digits_bound(B: int, n: int, Lr: int, W: int, n_pad: int):
    """K5: the B x n scalars' int32 limbs read once, the (B*W, n_pad) int16
    codes written once; no multiplies."""
    return bound_ms(4 * B * n * Lr + 2 * B * W * n_pad, 0)


# ---------------------------------------------------------------------------
# K6, the MSM's group merge (ops/msm.py bucket_merge)
# ---------------------------------------------------------------------------


def merge_bound(G: int, BW: int, K: int, L: int = 16):
    """K6 over (G, BW, K) buckets at L limbs: (G - 1) x BW x (K - 1)
    complete adds (row k = 0 is never summed), each bucket of the rows
    k >= 1 read once and the (BW, K) sums written once."""
    ops = (G - 1) * BW * (K - 1) * (EC_ADD_OPS_24 if L == 24 else EC_ADD_OPS)
    nbytes = 3 * 4 * L * BW * (G * (K - 1) + K)
    return bound_ms(nbytes, ops)
