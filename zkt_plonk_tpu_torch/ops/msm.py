"""Multi-scalar multiplication on device (Pippenger with grouped buckets).

Same method as ``zkt_plonk_tpu/ops/msm.py`` — signed c-bit windows, G
groups of private bucket arrays walked in S = n/G serial steps, group merge
by pairwise halving, the weighted bucket sum as a suffix scan and a sum,
the window fold on the host — with the bucket layout chosen for the card:

* a whole BATCH of B scalar vectors over the same points accumulates in
  one pass (the commit batches of the prover share the SRS points), so one
  step adds B*W*G points with a single launch of kernel K4;
* G from a sweep on the card (``group_count``): for n = 2^18 + 4, c = 8
  (W = 32 windows, K = 129 buckets) it is 2048/B rounded to a power of
  two, so each step adds 49,152 to 81,920 points (B = 1 to 10) in one K4
  launch;
* the bucket tensor is laid out group-major (G, B*W, K) so every merge
  step adds two contiguous halves;
* digits, bucket addresses and point addresses of all steps are computed
  in bulk before the loop; a step is two gathers, K4, one ``index_copy_``.

Only the final affine point has to match the JAX MSM; the bucket layout is
this module's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import LIMB_BITS, FieldSpec
from . import ec

DEFAULT_WINDOW = 8


def num_windows(fr_bits: int, c: int) -> int:
    return -(-fr_bits // c)


def window_digits(scalars: torch.Tensor, c: int, fr_bits: int) -> torch.Tensor:
    """(n, L) canonical scalar limbs -> (W, n) int64 window digits."""
    n, L = scalars.shape
    padded = torch.nn.functional.pad(scalars.to(torch.int64), (0, 2))
    mask = (1 << c) - 1
    digits = []
    for w in range(num_windows(fr_bits, c)):
        li, of = divmod(c * w, LIMB_BITS)
        lo = padded[:, li] if li < L + 2 else torch.zeros_like(padded[:, 0])
        hi = padded[:, li + 1] if li + 1 < L + 2 else torch.zeros_like(padded[:, 0])
        word = lo | (hi << LIMB_BITS)
        digits.append((word >> of) & mask)
    return torch.stack(digits)


def signed_window_digits(scalars: torch.Tensor, c: int, fr_bits: int):
    """Signed c-bit recoding: digit in [-2^(c-1), 2^(c-1)].

    Returns (magnitudes (W, n) in [0, half], negate-flags (W, n) bool) with
    W = num_windows(fr_bits + 1, c); a raw digit d > half becomes
    d - 2^c < 0 with a +1 carry into the next window (the top raw digit is
    < half, so the final carry is always absorbed).
    """
    half = 1 << (c - 1)
    full = 1 << c
    raw = window_digits(scalars, c, fr_bits + 1)
    mags, negs = [], []
    carry = torch.zeros_like(raw[0])
    for w in range(raw.shape[0]):
        d = raw[w] + carry
        over = d > half
        mags.append(torch.where(over, full - d, d))
        negs.append(over)
        carry = over.to(torch.int64)
    return torch.stack(mags), torch.stack(negs)


def msm_window_size(n: int, c: int = 0) -> int:
    if c > 0:
        return c
    return 4 if n <= (1 << 12) else 8


def group_count(n: int, c: int, batch: int) -> int:
    """The bucket group count G for B = ``batch`` MSMs over n points: n/(B*K)
    as a power of two in [1, 2048], so that the group merge (G*B*W*K point
    adds) adds as many points as one scalar's accumulation (n*W).

    Measured on an H100 (``tools/sweep_msm_groups.py``, PERF.md): at n =
    2^18 + 4, c = 8 this gives G = 2048, 1024 and 512 for B = 1, 2 and 3,
    the best of G = 32..2048 for each, and 256 for B = 6 and 10, where the
    commit time is flat from G = 128 to 1024 within the run-to-run spread.
    """
    K = (1 << (c - 1)) + 1
    g = round(np.log2(max(n / (batch * K), 1.0)))
    return 1 << min(g, 11)


def _accumulate(fq_spec, b3, points, scalars, fr_bits, c, G):
    """Grouped serial bucket accumulation -> (G, B*W, K, 3, L).

    points (n, 3, L); scalars (B, n, Lr).  Group g owns points g, g+G, ...
    in step order; a negative digit adds the negated point.  Digit-0
    buckets collect junk (including the identity padding) and are never
    weighted.
    """
    B, n, Lr = scalars.shape
    L = fq_spec.n_limbs
    dev = points.device
    K = (1 << (c - 1)) + 1
    digits, negs = signed_window_digits(scalars.reshape(B * n, Lr), c, fr_bits)
    W = digits.shape[0]
    BW = B * W
    S = -(-n // G)
    n_pad = S * G
    digits = digits.reshape(W, B, n).transpose(0, 1).reshape(BW, n)
    negs = negs.reshape(W, B, n).transpose(0, 1).reshape(BW, n)
    if n_pad != n:
        points = torch.cat([points, ec.identity(fq_spec, (n_pad - n,), device=dev)])
        digits = torch.nn.functional.pad(digits, (0, n_pad - n))
        negs = torch.nn.functional.pad(negs, (0, n_pad - n))
    all_pts = torch.cat([points, ec.neg(fq_spec, points)]).contiguous()  # (2 n_pad, 3, L)

    # step j, group g handles point j*G + g; bucket (g, bw, digit)
    g_idx = torch.arange(G, device=dev)
    base = (g_idx[:, None] * BW + torch.arange(BW, device=dev)[None, :]) * K  # (G, BW)
    dig = digits.reshape(BW, S, G).permute(1, 2, 0)  # (S, G, BW)
    neg = negs.reshape(BW, S, G).permute(1, 2, 0)
    lin_all = (base[None] + dig).reshape(S, G * BW)
    pt_all = (
        torch.arange(n_pad, device=dev).reshape(S, G, 1) + neg.to(torch.int64) * n_pad
    ).reshape(S, G * BW)

    buckets = ec.identity(fq_spec, (G * BW * K,), device=dev).contiguous()
    for j in range(S):
        lin = lin_all[j]
        cur = buckets.index_select(0, lin)
        q = all_pts.index_select(0, pt_all[j])
        buckets.index_copy_(0, lin, ec.add(fq_spec, b3, cur, q))
    return buckets.reshape(G, BW, K, 3, L)


def _tree_reduce_points(fq_spec, b3, pts: torch.Tensor) -> torch.Tensor:
    """EC sum along axis 0 by pairwise halving (k-1 adds, depth log2 k)."""
    k = pts.shape[0]
    while k > 1:
        half = k // 2
        merged = ec.add(fq_spec, b3, pts[:half], pts[half : 2 * half])
        if k % 2:
            merged = torch.cat([merged, pts[k - 1 : k]])
        pts = merged
        k = pts.shape[0]
    return pts[0]


def _suffix_scan(fq_spec, b3, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive suffix EC sums along ``axis`` (Hillis-Steele)."""
    k = x.shape[axis]
    d = 1
    while d < k:
        nxt = x.clone()
        nxt.narrow(axis, 0, k - d).copy_(
            ec.add(fq_spec, b3, x.narrow(axis, 0, k - d), x.narrow(axis, d, k - d))
        )
        x = nxt
        d <<= 1
    return x


def _reduce_buckets(fq_spec, b3, buckets):
    """(G, BW, K, 3, L) group buckets -> (BW, 3, L) weighted totals Σ k·B_k
    = Σ_{k>=1} SS_k with SS the suffix scan over buckets (the k = 0
    bucket, which holds the padding, is never summed)."""
    Bk = _tree_reduce_points(fq_spec, b3, buckets)  # (BW, K, 3, L)
    SS = _suffix_scan(fq_spec, b3, Bk, axis=1)
    return _tree_reduce_points(fq_spec, b3, SS[:, 1:].transpose(0, 1).contiguous())


def msm_totals(
    fq_spec: FieldSpec,
    b3: ec.B3,
    points: torch.Tensor,
    scalars: torch.Tensor,
    fr_bits: int,
    c: int = 0,
    groups: int = 0,
) -> torch.Tensor:
    """Device part of the MSM up to the per-window totals.

    points (n, 3, L); scalars (n, Lr) or a batch (B, n, Lr).  Returns
    (W, 3, L) or (B, W, 3, L); ``fold_windows_host`` finishes each.
    """
    batched = scalars.dim() == 3
    sc = scalars if batched else scalars[None]
    n = points.shape[0]
    c = msm_window_size(n, c)
    G = groups if groups > 0 else group_count(n, c, sc.shape[0])
    buckets = _accumulate(fq_spec, b3, points, sc, fr_bits, c, G)
    totals = _reduce_buckets(fq_spec, b3, buckets)
    totals = totals.reshape(sc.shape[0], -1, 3, fq_spec.n_limbs)
    return totals if batched else totals[0]


def fold_windows_host(fq_spec: FieldSpec, Fq, totals, c: int):
    """Host Horner over window totals: acc = 2^c*acc + T_w, high first.

    totals: (W, 3, L) projective points. Returns an affine ``(int, int)``
    tuple or None.
    """
    from ..curves import curve_host as ch

    pts = ec.to_affine_host(fq_spec, totals)
    acc = None
    for t in reversed(pts):
        for _ in range(c):
            acc = ch.double(acc)
        acc = ch.add(acc, None if t is None else (Fq(t[0]), Fq(t[1])))
    return None if acc is None else (int(acc[0]), int(acc[1]))


def msm(fq_spec, Fq, b3, points, scalars, fr_bits: int, c: int = 0):
    """Σ scalars_i · points_i as a host affine point (or None)."""
    c = msm_window_size(points.shape[0], c)
    totals = msm_totals(fq_spec, b3, points, scalars, fr_bits, c=c)
    return fold_windows_host(fq_spec, Fq, totals, c)


# ---------------------------------------------------------------------------
# fixed-base MSM (known base point, e.g. SRS generation)
# ---------------------------------------------------------------------------


def fixed_base_tables(ctx, base_affine, c: int = DEFAULT_WINDOW) -> np.ndarray:
    """Host-precomputed tables[w][d] = d·2^(cw)·G, shape (W, 2^c, 3, L)."""
    from ..curves import curve_host as ch

    fr_bits = ctx.curve.fr.modulus.bit_length()
    W = num_windows(fr_bits, c)
    K = 1 << c
    spec = ctx.fq_spec
    rows = []
    base = base_affine
    for _ in range(W):
        row = [None]
        for _ in range(K - 1):
            row.append(ch.add(row[-1], base))
        rows.append(ec.from_affine_host(spec, row))
        for _ in range(c):
            base = ch.double(base)
    return np.stack(rows)  # (W, K, 3, L)


def fixed_base_msm(
    fq_spec: FieldSpec,
    b3: ec.B3,
    tables: torch.Tensor,
    scalars: torch.Tensor,
    fr_bits: int,
    c: int = DEFAULT_WINDOW,
) -> torch.Tensor:
    """[s_i · G for each scalar] via window tables; returns (n, 3, L)."""
    digits = window_digits(scalars, c, fr_bits)  # (W, n)
    n = scalars.shape[0]
    acc = ec.identity(fq_spec, (n,), device=scalars.device)
    for w in range(digits.shape[0]):
        acc = ec.add(fq_spec, b3, acc, tables[w].index_select(0, digits[w]))
    return acc
