"""Multi-scalar multiplication on device (Pippenger with grouped buckets).

Same method as ``zkt_plonk_tpu/ops/msm.py`` — signed c-bit windows, G
groups of private bucket arrays walked in S = n/G serial steps, a group
merge, the weighted bucket sum as a suffix scan and a sum, the window fold
on the host — with the bucket layout chosen for the card:

* a whole BATCH of B scalar vectors over the same points accumulates in
  one pass (the commit batches of the prover share the SRS points);
* the accumulation is kernel K4a (``bucket_accumulate``), one launch per
  batch: a thread owns one bucket row (g, b*W + w) and walks the S steps
  itself, so the per-step gathers and scatters stay inside the kernel;
* K4a takes points with Z = 1: the MSM runs over a ``CommitPoints``, the
  Z = 1 copy of a key's points made once (``commit_points``), or of a bare
  points tensor once per ``msm`` call; so a step is a mixed add, a
  bucket's first hit two products and a padding step three;
* the group merge is kernel K6 (``bucket_merge``), one or two launches
  per batch: a thread sums one bucket column over a chunk of the groups,
  and the bucket tensor is laid out group-major (G, B*W, K) so that a
  warp's columns of one group are neighbours; the suffix scan and the final
  sum are K4;
* digits are computed in bulk before the accumulation, as int16 codes, by
  kernel K5 (``digit_rows``), one launch per batch.

Only the final affine point has to match the JAX MSM; the bucket layout is
this module's own.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from ..fields import cuda as fc
from ..fields.limbs import LIMB_BITS, FieldSpec, int_to_limbs
from ..utils import profiling
from ..utils.scan import scan, tree_reduce
from . import ec, ec_cuda

DEFAULT_WINDOW = 8


def num_windows(fr_bits: int, c: int) -> int:
    return -(-fr_bits // c)


def _window(padded: torch.Tensor, w: int, c: int) -> torch.Tensor:
    """Window w (bits c*w .. c*w + c - 1) of int64 limbs padded by two zero
    limbs, as int64 (n,)."""
    li, of = divmod(c * w, LIMB_BITS)
    width = padded.shape[1]
    lo = padded[:, li] if li < width else torch.zeros_like(padded[:, 0])
    hi = padded[:, li + 1] if li + 1 < width else torch.zeros_like(padded[:, 0])
    return ((lo | (hi << LIMB_BITS)) >> of) & ((1 << c) - 1)


def window_digits(scalars: torch.Tensor, c: int, fr_bits: int) -> torch.Tensor:
    """(n, L) canonical scalar limbs -> (W, n) int64 window digits."""
    padded = torch.nn.functional.pad(scalars.to(torch.int64), (0, 2))
    return torch.stack([_window(padded, w, c) for w in range(num_windows(fr_bits, c))])


def signed_digit_codes(scalars: torch.Tensor, c: int, fr_bits: int) -> torch.Tensor:
    """Signed c-bit recoding as (W, n) int16 codes, W = num_windows(fr_bits
    + 1, c).

    A raw digit d > 2^(c-1) becomes d - 2^c < 0 with a +1 carry into the
    next window (the top raw digit is < 2^(c-1), so the final carry is
    always absorbed).  A digit of magnitude m is coded m when it is
    positive and ~m = -m - 1 when it is negative, so a negative zero (a raw
    2^c - 1 plus a carry) keeps its sign: its bucket gets -P, as in the
    reference.
    """
    half = 1 << (c - 1)
    full = 1 << c
    padded = torch.nn.functional.pad(scalars.to(torch.int64), (0, 2))
    W = num_windows(fr_bits + 1, c)
    codes = torch.empty((W, scalars.shape[0]), dtype=torch.int16, device=scalars.device)
    carry = torch.zeros_like(padded[:, 0])
    for w in range(W):
        d = _window(padded, w, c) + carry
        over = d > half
        codes[w] = torch.where(over, d - (full + 1), d)
        carry = over.to(torch.int64)
    return codes


def msm_window_size(n: int, c: int = 0) -> int:
    if c > 0:
        return c
    return 4 if n <= (1 << 12) else 8


# Resident blocks per SM of K4a's ACC_THREADS-thread blocks on an H100's
# 132 SMs, at each limb count, from ptxas's register count of each
# instance (PERF.md).  chip_smoke.py holds the table against the card's
# occupancy call (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a table
# rather than the call, so that the CPU path picks the same G as the card.
ACC_THREADS = 128
ACC_SMS = 132
ACC_RESIDENT_BLOCKS = {16: 3, 24: 3}
# K4a keeps two K-bit masks per thread in shared memory, within 48 KB a
# block beside the L = 24 instance's 36 KB of staged values: windows up to
# c = 11 (K = 1025) at L = 16, c = 9 (K = 257) at L = 24
ACC_MAX_C = {16: 11, 24: 9}
# The G rule aims at this share of an instance's resident bucket rows, and
# at no more than ACC_ROWS_MAX rows.  From the sweeps of
# tools/sweep_msm_groups.py (PERF.md): K4a's instances of earlier designs
# were fastest between 32,768 and 49,152 rows at every batch size, and at
# 81% of the rows of a 12-word instance at 2 blocks (33,792 rows).  Both
# instances now run at 3 blocks (50,688 rows), so the 40,960-row cap binds
# at both widths; the sweep at L = 24 found the rule's G within 0-8% of the
# best G at B = 1, 2, 3 and 6.  Past that, more rows only add per-row work
# and group-merge adds.
ACC_ROW_SHARE = 0.81
ACC_ROWS_MAX = 40960


def resident_rows(limbs: int) -> int:
    """K4a's bucket rows (threads) resident at once on the card at L limbs."""
    return ACC_RESIDENT_BLOCKS[limbs] * ACC_THREADS * ACC_SMS


def group_count(n: int, c: int, batch: int, windows: int, limbs: int) -> int:
    """The bucket group count G for B = ``batch`` MSMs of ``windows`` windows
    over n points, with K4a's instance at ``limbs`` limbs: a power of two,
    the smaller of
    * min(ACC_ROW_SHARE * resident_rows(limbs), ACC_ROWS_MAX) / (B*W):
      enough K4a threads to keep the card busy in one wave, and few enough
      that the per-row work (K bucket initialisations and conversions in
      K4a, G*B*W*K adds in the group merge) stays small;
    * n / (B*K): the group merge adds no more points than one scalar's
      accumulation (n*W), which bounds G for small n.
    At n = 2^18 + 4, c = 8 it gives G = 1024, 512, 512, 256 and 128 for
    B = 1, 2, 3, 6 and 10 at L = 16 and at L = 24.
    """
    K = (1 << (c - 1)) + 1
    rows = min(ACC_ROW_SHARE * resident_rows(limbs), ACC_ROWS_MAX)
    by_rows = np.log2(rows / (batch * windows))
    by_merge = np.log2(max(n / (batch * K), 1.0))
    return 1 << max(0, min(round(by_rows), round(by_merge)))


def bucket_accumulate_plain(
    spec: FieldSpec, b3: ec.B3, points: torch.Tensor, digits: torch.Tensor, G: int, c: int
) -> torch.Tensor:
    """The plain PyTorch version of K4a: the per-step loop, one gather of
    the current buckets and of the (negated) points, one plain EC add and
    one scatter per step."""
    BW, n_pad = digits.shape
    n = points.shape[0]
    L = spec.n_limbs
    K = (1 << (c - 1)) + 1
    S = n_pad // G
    dev = points.device
    codes = digits.to(torch.int64)
    negs = codes < 0
    mags = torch.where(negs, ~codes, codes)
    if n_pad != n:
        points = torch.cat([points, ec.identity(spec, (n_pad - n,), device=dev)])
    zero = torch.zeros_like(points[:, 1])
    neg_y = fc.binop_plain(spec, "sub", zero, points[:, 1])
    neg_pts = torch.stack([points[:, 0], neg_y, points[:, 2]], dim=1)
    all_pts = torch.cat([points, neg_pts]).contiguous()  # (2 n_pad, 3, L)

    # step j, group g handles point j*G + g; bucket (g, bw, |digit|)
    base = (torch.arange(G, device=dev)[:, None] * BW + torch.arange(BW, device=dev)[None, :]) * K
    mag = mags.reshape(BW, S, G).permute(1, 2, 0)  # (S, G, BW)
    neg = negs.reshape(BW, S, G).permute(1, 2, 0)
    lin_all = (base[None] + mag).reshape(S, G * BW)
    pt_all = (
        torch.arange(n_pad, device=dev).reshape(S, G, 1) + neg.to(torch.int64) * n_pad
    ).reshape(S, G * BW)

    buckets = ec.identity(spec, (G * BW * K,), device=dev).contiguous()
    for j in range(S):
        lin = lin_all[j]
        cur = buckets.index_select(0, lin)
        q = all_pts.index_select(0, pt_all[j])
        buckets.index_copy_(0, lin, ec_cuda.add_plain(spec, b3.limbs, cur, q))
    return buckets.reshape(G, BW, K, 3, L)


def bucket_accumulate(
    spec: FieldSpec, b3: ec.B3, points: torch.Tensor, digits: torch.Tensor, G: int, c: int
) -> torch.Tensor:
    """Grouped serial bucket accumulation -> (G, BW, K, 3, L) canonical
    limbs, K = 2^(c-1) + 1.

    points (n, 3, L) int32 with Z = 1; digits (BW, n_pad) int16 codes of
    ``signed_digit_codes`` (one row per scalar and window), zero-padded to
    n_pad = S*G >= n.  Group g owns points g, g+G, ... in step order; a
    negative digit adds the negated point; points past n are the identity.
    Digit-0 buckets collect junk (including the identity padding) and are
    never weighted.  Codes must lie in [-K, K), as ``digit_rows`` makes
    them, and Z must be 1 (``commit_points``), since the kernel never reads
    it; only the CPU path checks both, since a check on the card would make
    the host wait for it on every batch.  Windows up to c = ACC_MAX_C[L].
    Kernel K4a on the card, the plain version on the CPU.
    """
    L = spec.n_limbs
    if points.dtype != torch.int32 or points.dim() != 3 or tuple(points.shape[1:]) != (3, L):
        raise ValueError(f"points: expected (n, 3, {L}) int32, got {tuple(points.shape)} {points.dtype}")
    if digits.dtype != torch.int16 or digits.dim() != 2:
        raise ValueError(f"digits: expected (BW, n_pad) int16, got {tuple(digits.shape)} {digits.dtype}")
    BW, n_pad = digits.shape
    n = points.shape[0]
    K = (1 << (c - 1)) + 1
    if G < 1 or n_pad % G or n_pad < n or n_pad == 0:
        raise ValueError(f"digits cover {n_pad} points: need a multiple of G={G} and >= {n}")
    key = _cuda.instance("ec_bucket_accumulate", L)
    if c > ACC_MAX_C[L]:
        raise ValueError(f"{key} takes windows up to c = {ACC_MAX_C[L]}, got {c}")
    _cuda.count_work("ec_bucket_adds", BW * n)
    if points.device.type == "cpu" and digits.device.type == "cpu":
        lo, hi = torch.aminmax(digits)
        if hi.item() >= K or ~lo.item() >= K:
            raise ValueError(f"digit codes out of range for K={K} buckets")
        z = points[:, 2]
        if not bool((z[:, 0] == 1).all() and (z[:, 1:] == 0).all()):
            raise ValueError(f"{key} needs points with Z = 1 (commit_points)")
        return bucket_accumulate_plain(spec, b3, points, digits, G, c)
    if points.device != digits.device or points.device.type != "cuda":
        raise ValueError(f"points on {points.device}, digits on {digits.device}")
    if not 0 <= b3.value < 256:
        raise ValueError("ec_bucket_accumulate needs 3b < 256")
    points = points.contiguous()
    digits = digits.contiguous()
    out = torch.empty((G, BW, K, 3, L), dtype=torch.int32, device=points.device)
    # (x, y) of the points in packed Montgomery words
    pm = torch.empty((n, 2, L // 2), dtype=torch.int32, device=points.device)
    err = _cuda.lib("ec_bucket_accumulate").zk_ec_bucket_accumulate(
        L, points.data_ptr(), n, pm.data_ptr(), digits.data_ptr(), out.data_ptr(),
        G, BW, K, n_pad // G, b3.value, _cuda.ec_field_consts(spec), _cuda.stream_ptr(points),
    )
    _cuda.check(err, key)
    _cuda.count(key)
    return out


# K5 takes up to 16 limbs a scalar and windows up to 15 bits: a window spans
# at most two limbs and its codes fit int16
DIGIT_MAX_LIMBS = 16
DIGIT_MAX_C = 15


def digit_rows_plain(scalars: torch.Tensor, c: int, fr_bits: int, G: int) -> torch.Tensor:
    """The plain PyTorch version of K5: ``signed_digit_codes`` of all B*n
    scalars, then a transpose and a pad."""
    B, n, Lr = scalars.shape
    codes = signed_digit_codes(scalars.reshape(B * n, Lr), c, fr_bits)  # (W, B*n)
    W = codes.shape[0]
    digits = codes.reshape(W, B, n).transpose(0, 1).reshape(B * W, n)
    return torch.nn.functional.pad(digits, (0, -(-n // G) * G - n))


def digit_rows(scalars: torch.Tensor, c: int, fr_bits: int, G: int) -> torch.Tensor:
    """(B, n, Lr) canonical scalar limbs -> (B*W, n_pad) int16 digit codes
    of ``signed_digit_codes``, row b*W + w for window w of scalar vector b,
    zero-padded to n_pad = ceil(n/G)*G.  Kernel K5 (``msm_digits``, one
    launch) on the card, ``digit_rows_plain`` on the CPU."""
    B, n, Lr = scalars.shape
    W = num_windows(fr_bits + 1, c)
    n_pad = -(-n // G) * G
    _cuda.count_work("msm_digit_codes", B * W * n_pad)
    if scalars.device.type == "cpu":
        return digit_rows_plain(scalars, c, fr_bits, G)
    if scalars.device.type != "cuda":
        raise ValueError(f"scalars on {scalars.device}")
    if scalars.dtype != torch.int32 or not 1 <= Lr <= DIGIT_MAX_LIMBS or not 1 <= c <= DIGIT_MAX_C:
        raise ValueError(
            f"msm_digits takes (B, n, <= {DIGIT_MAX_LIMBS}) int32 limbs and c <= {DIGIT_MAX_C}, "
            f"got {tuple(scalars.shape)} {scalars.dtype}, c = {c}")
    scalars = scalars.contiguous()
    out = torch.empty((B * W, n_pad), dtype=torch.int16, device=scalars.device)
    err = _cuda.lib("msm_digits").zk_msm_digits(
        scalars.data_ptr(), out.data_ptr(), B, n, Lr, n_pad, c, W, _cuda.stream_ptr(scalars))
    _cuda.check(err, "msm_digits")
    _cuda.count("msm_digits")
    return out


# K6 (``bucket_merge``) runs MERGE_THREADS-thread blocks; resident blocks per
# SM of each instance on an H100, from ptxas's register count (PERF.md).
# chip_smoke.py holds the table against the card's occupancy call; a table
# rather than the call, so that the CPU path picks the same chunk count,
# and so the same words, as the card.
MERGE_THREADS = 128
MERGE_RESIDENT_BLOCKS = {16: 3, 24: 3}


def merge_chunks(G: int, columns: int, limbs: int) -> int:
    """The chunks C that K6's first launch splits each of ``columns`` bucket
    columns' G groups into, at least 1 and the smaller of
    * as many as one wave of the instance's resident threads holds
      (columns x C of them): the prover's batches, whose columns fill the
      card in a few chunks;
    * sqrt(G): where the columns are few, a thread's chain of G/C adds and
      the second launch's C - 1 are about as long."""
    resident = MERGE_RESIDENT_BLOCKS[limbs] * MERGE_THREADS * ACC_SMS
    return max(1, min(resident // columns, math.isqrt(G)))


@lru_cache(maxsize=None)
def _montgomery_scales(spec: FieldSpec, device: torch.device):
    """R^-1 and R mod p (R = 2^(16 L)) as int64 limbs."""
    p, L = spec.modulus, spec.n_limbs
    R = 1 << (LIMB_BITS * L)
    return tuple(torch.tensor(int_to_limbs(v, L).astype(np.int64), device=device)
                 for v in (pow(R, -1, p), R % p))


def _merge_pass_plain(spec: FieldSpec, b3: ec.B3, buckets: torch.Tensor, C: int) -> torch.Tensor:
    """One launch of K6 in plain PyTorch: (G, BW, K, 3, L) -> (C, BW, K, 3,
    L).  Chunk j sums groups floor(jG/C) .. floor((j+1)G/C) - 1 of each
    column k >= 1 in order, on the buckets' canonical limbs read as
    Montgomery words (the values times R^-1), and writes the canonical
    words of the sum (its values times R); row 0 is the identity."""
    G, BW, K, _, L = buckets.shape
    rinv, rmod = _montgomery_scales(spec, buckets.device)
    # the values of groups ``rows``, one step's operands at a time
    words = lambda rows: fc.mul64(spec, buckets[rows, :, 1:].to(torch.int64), rinv).to(torch.int32)
    bounds = torch.tensor([j * G // C for j in range(C + 1)], device=buckets.device)
    first, lens = bounds[:-1], bounds[1:] - bounds[:-1]
    acc = words(first)  # (C, BW, K - 1, 3, L)
    for s in range(1, int(lens.max())):
        live = lens > s
        acc[live] = ec_cuda.add_plain(spec, b3.limbs, acc[live], words(first[live] + s))
    out = ec.identity(spec, (C, BW, K), device=buckets.device).clone()
    out[:, :, 1:] = fc.mul64(spec, acc.to(torch.int64), rmod).to(torch.int32)
    return out


def bucket_merge_plain(spec: FieldSpec, b3: ec.B3, buckets: torch.Tensor, chunks: int) -> torch.Tensor:
    """The plain PyTorch version of K6: the same adds in the same order,
    so the same words.  ``chunks`` partial sums a column, then one chain
    over them where there are several."""
    out = _merge_pass_plain(spec, b3, buckets, chunks)
    return (_merge_pass_plain(spec, b3, out, 1) if chunks > 1 else out)[0]


def bucket_merge(spec: FieldSpec, b3: ec.B3, buckets: torch.Tensor) -> torch.Tensor:
    """The group merge: (G, BW, K, 3, L) buckets of canonical limbs ->
    (BW, K, 3, L), bucket (bw, k) the sum over the G groups for k >= 1 (as
    canonical limbs of some projective representative) and row k = 0 the
    identity, since the MSM never weights it.  Kernel K6
    (``ec_bucket_merge``) on the card, one launch with ``merge_chunks``
    chunks a column and, where that is more than one, a second over the
    partial sums; ``bucket_merge_plain`` on the CPU."""
    L = spec.n_limbs
    if buckets.dtype != torch.int32 or buckets.dim() != 5 or tuple(buckets.shape[3:]) != (3, L):
        raise ValueError(
            f"buckets: expected (G, BW, K, 3, {L}) int32, got {tuple(buckets.shape)} {buckets.dtype}")
    G, BW, K = buckets.shape[:3]
    if G < 1 or BW < 1 or K < 2:
        raise ValueError(f"buckets: need G, BW >= 1 and K >= 2, got {(G, BW, K)}")
    if buckets.device.type not in ("cpu", "cuda"):
        raise ValueError(f"buckets on {buckets.device}")
    C = merge_chunks(G, BW * (K - 1), L)
    key = _cuda.instance("ec_bucket_merge", L)
    _cuda.count_work("ec_merge_adds", (G - 1) * BW * (K - 1))
    if buckets.device.type == "cpu":
        return bucket_merge_plain(spec, b3, buckets, C)
    if not 0 <= b3.value < 256:
        raise ValueError("ec_bucket_merge needs 3b < 256")
    consts = _cuda.ec_field_consts(spec)
    fn = _cuda.lib("ec_bucket_merge").zk_ec_bucket_merge

    def launch(src: torch.Tensor, groups: int, chunks: int) -> torch.Tensor:
        out = torch.empty((chunks, BW, K, 3, L), dtype=torch.int32, device=src.device)
        err = fn(L, src.data_ptr(), out.data_ptr(), groups, chunks, BW, K, b3.value, consts,
                 _cuda.stream_ptr(src))
        _cuda.check(err, key)
        _cuda.count(key)
        return out

    out = launch(buckets.contiguous(), G, C)
    return (launch(out, C, 1) if C > 1 else out)[0]


class CommitPoints(NamedTuple):
    """An MSM's (n, 3, L) points with Z = 1, as K4a takes them
    (``commit_points``): the one form of points the MSM functions below
    take."""

    points: torch.Tensor


def z1_points(points: CommitPoints) -> torch.Tensor:
    """The (n, 3, L) tensor of a CommitPoints.  Anything else raises
    TypeError: a key makes its Z = 1 copy once (``commit_points``), ``msm``
    one per call."""
    if not isinstance(points, CommitPoints):
        raise TypeError(f"the MSM takes a msm.CommitPoints (commit_points), not a {type(points).__name__}")
    return points.points


def _accumulate(fq_spec, b3, points: CommitPoints, scalars, fr_bits, c, G):
    """Grouped serial bucket accumulation of B scalar vectors (B, n, Lr)
    over a CommitPoints -> (G, B*W, K, 3, L)."""
    pts = z1_points(points)
    digits = digit_rows(scalars, c, fr_bits, G)
    return bucket_accumulate(fq_spec, b3, pts, digits, G, c)


def _reduce_buckets(fq_spec, b3, buckets):
    """(G, BW, K, 3, L) group buckets -> (BW, 3, L) weighted totals Σ k·B_k
    = Σ_{k>=1} SS_k with SS the suffix scan over buckets (the k = 0
    bucket, which holds the padding, is never summed): the group merge on
    K6, the scan and the sum on K4."""
    add = lambda a, b: ec.add(fq_spec, b3, a, b)
    Bk = bucket_merge(fq_spec, b3, buckets)  # (BW, K, 3, L)
    SS = scan(add, Bk, 1, reverse=True)
    return tree_reduce(add, SS[:, 1:].transpose(0, 1).contiguous(), 0)


def msm_totals(
    fq_spec: FieldSpec,
    b3: ec.B3,
    points: CommitPoints,
    scalars: torch.Tensor,
    fr_bits: int,
    c: int = 0,
    groups: int = 0,
) -> torch.Tensor:
    """Device part of the MSM up to the per-window totals.

    points a CommitPoints of n points; scalars (n, Lr) or a batch
    (B, n, Lr).  Returns (W, 3, L) or (B, W, 3, L); ``fold_windows_host``
    finishes each.
    """
    batched = scalars.dim() == 3
    sc = scalars if batched else scalars[None]
    n = z1_points(points).shape[0]
    c = msm_window_size(n, c)
    W = num_windows(fr_bits + 1, c)
    G = groups if groups > 0 else group_count(n, c, sc.shape[0], W, fq_spec.n_limbs)
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


def msm(fq_spec, Fq, b3, points: torch.Tensor, scalars: torch.Tensor, fr_bits: int, c: int = 0):
    """Σ scalars_i · points_i as a host affine point (or None) over bare
    (n, 3, L) projective points and (n, Lr) scalars: the one-shot MSM of
    tests and tools.  The identity rows (Z = 0), which add nothing and have
    no Z = 1 form, drop out with their scalars; the rest get a Z = 1 copy
    (``commit_points``) for this call."""
    keep = (points[:, 2] != 0).any(-1)
    points, scalars = points[keep], scalars[keep]
    if points.shape[0] == 0:
        return None
    c = msm_window_size(points.shape[0], c)
    totals = msm_totals(fq_spec, b3, commit_points(fq_spec, points), scalars, fr_bits, c=c)
    return fold_windows_host(fq_spec, Fq, totals, c)


def commit_points(spec: FieldSpec, points: torch.Tensor) -> CommitPoints:
    """A key's (N, 3, L) points as its commits take them: a Z = 1 copy
    (``ec.normalize``), for K4a.  Each key builds it once
    (``kzg.CommitterKey.msm_points``, ``ipa.CommitterKeyIPA.msm_points``)
    and never serializes it.  The copy changes the bucket words, not the
    points, so the commitments are the same.  On the card it waits for the
    copy's kernels, so that a committer on another CUDA stream
    (``parallel.BatchProver``'s rows) may read it at once."""
    copy = ec.normalize(spec, points)
    if copy.device.type == "cuda":
        torch.cuda.current_stream(copy.device).synchronize()
    return CommitPoints(copy)


def commit_rows(ctx, b3, points: CommitPoints, polys) -> list:
    """One commitment per row of ``polys`` ((B, m, L) tensor or a list of
    (m, L)) over the first m of ``points``, a key's CommitPoints, as one
    batched MSM on their device; host affine points (int pairs) or None."""
    pts = z1_points(points)
    stacked = polys if isinstance(polys, torch.Tensor) else torch.stack(list(polys))
    m = stacked.shape[1]
    c = msm_window_size(m)
    fr_bits = ctx.curve.fr.modulus.bit_length()
    with profiling.section("msm"):
        totals = msm_totals(ctx.fq_spec, b3, CommitPoints(pts[:m]), stacked, fr_bits, c=c)
    return fold_rows(ctx, totals, c)


def fold_rows(ctx, totals: torch.Tensor, c: int) -> list:
    """The host's part of a commit batch: wait for the (B, W, 3, L) window
    totals, then fold each row (``fold_windows_host``)."""
    with profiling.waiting():
        host = totals.cpu().numpy()
    with profiling.section("fold"):
        return [fold_windows_host(ctx.fq_spec, ctx.Fq, host[i], c) for i in range(len(host))]


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
