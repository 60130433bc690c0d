"""Mixed-radix multi-pass NTT: numpy plans, the K3 pass kernel, the driver.

The algorithm is that of ``zkt_plonk_tpu/ops/ntt_mr.py`` (Bailey's four-step
method generalized to D factors, n = F1*...*FD): pass d runs F_d-point DIT
NTTs down the rows of an (F_d, M_d) array whose rows are taken in
bit-reversed order, then multiplies by the inter-pass twiddles
w^(P_d t c) and transposes the next factor to the row axis.  ``factorize``,
``build_plan``, ``_stage_tws`` and the compact ``Tbl`` tables come across
unchanged as numpy, extended to the single-pass case (n <= 2^8, where 1/n
is an epilogue table instead of part of an inter-pass table).

``DevicePlan`` expands the compact tables once per plan into full
``(F, M)`` tables and keeps them, with the stage twiddles, as Montgomery
words (t*R mod p, 8 x 32 bits).  Each pass is ONE launch of kernel K3
(``ntt_col_pass``): the row gather, the prologue, the DIT stages, the
inter-pass table or epilogue and the transpose to the next pass's layout
all happen inside it, so a transform is D launches and nothing else.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _cuda
from ..fields import cuda as fc
from ..fields import device as fd
from ..fields.limbs import FieldSpec, ints_to_array

MB = 128  # lane block of the compact-table addressing (Tbl.k / Tbl.m)
FULL_TABLE_MAX = 1 << 16  # compact tables store O(n) entries up to this


def factorize(log_n: int) -> Tuple[int, ...]:
    """Split log2(n) into D factors: F1 = 128 (2^7), later factors <= 2^7,
    split evenly; a single pass for n <= 2^8."""
    k = log_n
    if k <= 8:
        return (k,)
    r = k - 7
    parts = -(-r // 7)  # remaining passes, each <= 7
    base, extra = divmod(r, parts)
    return (7,) + tuple(base + (1 if i < extra else 0) for i in range(parts))


def _bitrev_perm(F: int) -> np.ndarray:
    bits = F.bit_length() - 1
    idx = np.arange(F)
    out = np.zeros(F, dtype=np.int32)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _enc(values: Sequence[int], L: int, rows: int, lanes: int) -> np.ndarray:
    """ints (row-major rows x lanes) -> (rows, L, lanes) uint32."""
    arr = ints_to_array(list(values), L).reshape(rows, lanes, L)
    return np.ascontiguousarray(arr.transpose(0, 2, 1))


class Tbl:
    """A multiplicative table + static block addressing.

    For lane-block j the table block is column-block ``(j // k) % m`` of
    ``arr`` (rows, L, lanes); ``slice_`` selects a lane slice (one table
    lane per data lane) vs a broadcast column (one value per block).
    ``expand`` turns it into the full per-element table.
    """

    __slots__ = ("arr", "k", "m", "slice_")

    def __init__(self, arr, k: int, m: int, slice_: bool):
        self.arr = arr
        self.k = k
        self.m = m
        self.slice_ = slice_

    def expand(self, M: int) -> np.ndarray:
        """Full (rows, M, L) table for a width-M pass."""
        arr = self.arr
        lanes = arr.shape[-1]
        mb = min(MB, M)
        if self.slice_:
            full = arr if lanes == M else np.tile(arr, (1, 1, M // lanes))
        else:
            period = self.m * self.k * mb
            full = np.repeat(arr[..., : self.m], self.k * mb, axis=-1)
            if period < M:
                full = np.tile(full, (1, 1, M // period))
            full = full[..., :M]
        return np.ascontiguousarray(full.transpose(0, 2, 1))


class MrPlan:
    """All host tables for one direction (+ optional coset) of one size."""

    def __init__(self, n, factors, L, bitrevs, stage_tws, post, pro, epi):
        self.n = n
        self.factors = tuple(factors)
        self.L = L
        self.bitrevs = list(bitrevs)  # per pass: (F_d,) int32
        self.stage_tws = list(stage_tws)  # per pass: (F_d, L, 1)
        self.post = [list(ts) for ts in post]  # per pass: [Tbl]
        self.pro = list(pro)  # pass-1 prologue: [Tbl]
        self.epi = list(epi)  # last-pass epilogue: [Tbl]


def _stage_tws(p: int, w: int, F: int, L: int) -> np.ndarray:
    """Concatenated DIT stage twiddles: row (2^s + j) = w^(j * F / 2^(s+1)).

    Row 0 unused (stage 0 twiddles are 1 and skipped). w: F-th root of 1.
    """
    out = [0] * F
    logF = F.bit_length() - 1
    for s in range(logF):
        H = 1 << s
        base = pow(w, F >> (s + 1), p)
        cur = 1
        for j in range(H):
            out[H + j] = cur
            cur = cur * base % p
    return _enc(out, L, F, 1)


def _geom_tables(p, F, M, P, L, base, row_base=1, scale=1) -> List[Tbl]:
    """Tables multiplying x[t, m] by scale * row_base^t * base^(t*c) where
    c = m // P (trailing P indices share a column).  Shapes (F, L, *).
    """
    Q = M // P
    if F * Q <= FULL_TABLE_MAX and P == 1:
        vals = []
        for t in range(F):
            wt = pow(base, t, p)
            cur = pow(row_base, t, p) * scale % p
            for c in range(Q):
                vals.append(cur)
                cur = cur * wt % p
        return [Tbl(_enc(vals, L, F, Q), 1, max(Q // min(MB, Q), 1), True)]
    if P == 1:
        # compact split c = hi*Q_lo + lo; lo table is a lane slice,
        # hi table is column-constant per block
        Q_lo = MB
        while Q_lo * Q_lo < Q:
            Q_lo *= 2
        Q_hi = Q // Q_lo
        lo, hi = [], []
        for t in range(F):
            wt = pow(base, t, p)
            cur = 1
            for c in range(Q_lo):
                lo.append(cur)
                cur = cur * wt % p
            wt_hi = pow(base, t * Q_lo, p)
            cur = pow(row_base, t, p) * scale % p
            for h in range(Q_hi):
                hi.append(cur)
                cur = cur * wt_hi % p
        return [
            Tbl(_enc(lo, L, F, Q_lo), 1, Q_lo // MB, True),
            Tbl(_enc(hi, L, F, Q_hi), Q_lo // MB, Q_hi, False),
        ]
    # P >= MB: every lane block sits inside one c -> column-constant tables
    assert P % MB == 0, (P, MB)
    if F * Q <= FULL_TABLE_MAX:
        vals = []
        for t in range(F):
            wt = pow(base, t, p)
            cur = pow(row_base, t, p) * scale % p
            for c in range(Q):
                vals.append(cur)
                cur = cur * wt % p
        return [Tbl(_enc(vals, L, F, Q), P // MB, Q, False)]
    Q_lo = 1 << ((Q.bit_length() - 1 + 1) // 2)
    Q_hi = Q // Q_lo
    lo, hi = [], []
    for t in range(F):
        wt = pow(base, t, p)
        cur = 1
        for c in range(Q_lo):
            lo.append(cur)
            cur = cur * wt % p
        wt_hi = pow(base, t * Q_lo, p)
        cur = pow(row_base, t, p) * scale % p
        for h in range(Q_hi):
            hi.append(cur)
            cur = cur * wt_hi % p
    return [
        Tbl(_enc(lo, L, F, Q_lo), P // MB, Q_lo, False),
        Tbl(_enc(hi, L, F, Q_hi), P * Q_lo // MB, Q_hi, False),
    ]


def _row_geom_tables(p, M, L, base, scale=1) -> List[Tbl]:
    """Tables for x[:, m] *= scale * base^m (row-independent), rows=1."""
    if M <= FULL_TABLE_MAX:
        vals, cur = [], scale % p
        for _ in range(M):
            vals.append(cur)
            cur = cur * base % p
        return [Tbl(_enc(vals, L, 1, M), 1, max(M // min(MB, M), 1), True)]
    # compact split m = hi*M_lo + lo
    M_lo = MB
    while M_lo * M_lo < M:
        M_lo *= 2
    M_hi = M // M_lo
    lo, cur = [], 1
    for _ in range(M_lo):
        lo.append(cur)
        cur = cur * base % p
    base_hi = pow(base, M_lo, p)
    hi, cur = [], scale % p
    for _ in range(M_hi):
        hi.append(cur)
        cur = cur * base_hi % p
    return [
        Tbl(_enc(lo, L, 1, M_lo), 1, M_lo // MB, True),
        Tbl(_enc(hi, L, 1, M_hi), M_lo // MB, M_hi, False),
    ]


def build_plan(dom, *, inverse: bool, coset: bool) -> MrPlan:
    """Host-side table construction (numpy) for one ``Domain``."""
    p = dom.modulus
    L = dom.spec.n_limbs
    n = dom.size
    logn = dom.log_size
    factors = factorize(logn)
    D = len(factors)
    Fs = [1 << f for f in factors]

    w = dom.group_gen_inv if inverse else dom.group_gen
    g = dom.coset_gen
    n_inv = dom.size_inv

    bitrevs, stage_tws, post = [], [], []
    P = 1
    Q = n
    for d in range(D):
        F = Fs[d]
        Q //= F
        bitrevs.append(_bitrev_perm(F))
        stage_tws.append(_stage_tws(p, pow(w, n // F, p), F, L))
        if d < D - 1:
            scale = n_inv if (inverse and d == D - 2) else 1
            post.append(
                _geom_tables(p, F, Q * P, P, L, base=pow(w, P, p), scale=scale)
            )
        else:
            post.append([])
        P *= F

    pro: List[Tbl] = []
    epi: List[Tbl] = []
    if coset and not inverse:
        # prologue on pass-1 input: x[r, c] *= g^(r*C + c), rows in
        # BIT-REVERSED order (the row permutation happens before the pass)
        C = n // Fs[0]
        rows = [pow(g, int(r) * C, p) for r in _bitrev_perm(Fs[0])]
        pro.append(Tbl(_enc(rows, L, Fs[0], 1), 1, 1, False))
        pro.extend(_row_geom_tables(p, C, L, base=g))
    # single pass: no inter-pass table carries 1/n, so the epilogue does
    one_pass_scale = n_inv if (inverse and D == 1) else 1
    if coset and inverse:
        # epilogue on last-pass output: x[t, m] *= g^-(t*M + m)
        gi = pow(g, -1, p)
        F = Fs[-1]
        M = n // F
        rows = [pow(gi, t * M, p) * one_pass_scale % p for t in range(F)]
        epi.append(Tbl(_enc(rows, L, F, 1), 1, 1, False))
        epi.extend(_row_geom_tables(p, M, L, base=gi))
    elif inverse and D == 1:
        epi.append(Tbl(_enc([n_inv], L, 1, 1), 1, 1, False))

    return MrPlan(n, factors, L, bitrevs, stage_tws, post, pro, epi)


# ---------------------------------------------------------------------------
# device plan: stage twiddles and full tables as Montgomery words, built once
# ---------------------------------------------------------------------------


def limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., L) 16-bit limbs -> (..., L/2) packed 32-bit words as int32."""
    lo = limbs[..., 0::2].to(torch.int64)
    hi = limbs[..., 1::2].to(torch.int64)
    w = lo | (hi << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(..., NW) packed words (int32) -> (..., 2 NW) int64 16-bit limbs."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], -1).reshape(*w.shape[:-1], 2 * w.shape[-1])


def words_canonical(spec: FieldSpec, words: torch.Tensor) -> torch.Tensor:
    """Packed words of values below 2p (the card's intermediates) ->
    canonical int32 limbs."""
    limbs = words_to_limbs(words)
    return fc.add64(spec, limbs, torch.zeros_like(limbs)).to(torch.int32)


def _mont_words(spec: FieldSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of t -> packed words of t*R mod p (R = 2^(16 L))."""
    r = fd.constant(spec, 1 << (16 * spec.n_limbs), device=limbs.device)
    return limbs_to_words(fd.mul(spec, limbs, r)).contiguous()


def _from_mont(spec: FieldSpec, words: torch.Tensor) -> torch.Tensor:
    """Packed words of t*R mod p -> canonical int64 limbs of t."""
    p = spec.modulus
    r_inv = fd.constant(spec, pow(1 << (16 * spec.n_limbs), -1, p), device=words.device)
    return fc.mul64(spec, words_to_limbs(words), r_inv.to(torch.int64))


class DevicePlan:
    """One direction of one size on one device, in the form K3 reads: per
    pass the stage twiddles (F, NW) and, where the pass has one, its input
    table ``tin`` (pass 1's prologue, rows in natural order) and output table
    ``tout`` (the inter-pass twiddles, the epilogue on the last pass), full
    (F, M, NW); all as Montgomery words t*R mod p."""

    def __init__(self, spec: FieldSpec, plan: MrPlan, device: torch.device):
        self.n = plan.n
        self.factors = plan.factors
        Fs = [1 << f for f in plan.factors]
        self.Fs = Fs
        D = len(Fs)
        self.stage_tws = [
            _mont_words(spec, torch.from_numpy(tw[:, :, 0].astype(np.int32)).to(device))
            for tw in plan.stage_tws
        ]
        tables = [plan.post[d] if d < D - 1 else plan.epi for d in range(D)]
        self.tout = [_table_words(spec, ts, Fs[d], plan.n // Fs[d], device) for d, ts in enumerate(tables)]
        pro = _table_words(spec, plan.pro, Fs[0], plan.n // Fs[0], device)
        if pro is not None:
            # build_plan lists the prologue's rows in bit-reversed order (the
            # JAX transform gathers before it multiplies); K3 multiplies at the
            # row it loads, so natural order (bit reversal is an involution)
            pro = pro.index_select(0, torch.from_numpy(plan.bitrevs[0].astype(np.int64)).to(device))
        self.tin = pro


def _table_words(spec, tbls: List[Tbl], F: int, M: int, device) -> Optional[torch.Tensor]:
    full = None
    for t in tbls:
        arr = torch.from_numpy(t.expand(M).astype(np.int32)).to(device)
        full = arr if full is None else fd.mul(spec, full, arr)
    if full is None:
        return None
    return _mont_words(spec, full.expand(F, M, spec.n_limbs))


# ---------------------------------------------------------------------------
# K3: one fused radix-F pass
# ---------------------------------------------------------------------------


def col_pass_plain(spec: FieldSpec, x: torch.Tensor, stage_tws: torch.Tensor) -> torch.Tensor:
    """The radix-F column pass on canonical limbs: rows gathered in
    bit-reversed order, then all log2 F DIT stages along axis 0 of
    (F, M, L) with canonical stage twiddles (F, L), int64 limb math."""
    F, M, L = x.shape
    logF = F.bit_length() - 1
    rev = torch.from_numpy(_bitrev_perm(F).astype(np.int64)).to(x.device)
    y = x.index_select(0, rev).to(torch.int64)
    tws = stage_tws.to(torch.int64)
    for s in range(logF):
        H = 1 << s
        G = F // (2 * H)
        y4 = y.reshape(G, 2, H, M, L)
        u, v = y4[:, 0], y4[:, 1]
        if s > 0:
            v = fc.mul64(spec, v, tws[H : 2 * H].reshape(1, H, 1, L))
        y = torch.stack([fc.add64(spec, u, v), fc.sub64(spec, u, v)], 1).reshape(F, M, L)
    return y.to(torch.int32)


def _pass_dims(plan: DevicePlan, d: int):
    """(F, M, P, Qn) of pass d: F rows, M = n/F columns per polynomial,
    P = the product of the earlier factors, Qn = M / (P F_{d+1}) (0 on the
    last pass)."""
    Fs = plan.Fs
    F = Fs[d]
    M = plan.n // F
    P = 1
    for f in Fs[:d]:
        P *= f
    Qn = M // (P * Fs[d + 1]) if d < len(Fs) - 1 else 0
    return F, M, P, Qn


def fused_pass_plain(spec: FieldSpec, plan: DevicePlan, d: int, x: torch.Tensor, nb: int) -> torch.Tensor:
    """The plain PyTorch version of K3, on canonical limbs: gather and DIT
    stages (``col_pass_plain``), prologue, inter-pass table or epilogue,
    relayout.  x: pass 1 the caller's (nb, n, L); a later pass the previous
    pass's output (F, nb M, L).  Returns pass d+1's input
    (F_{d+1}, nb n / F_{d+1}, L), or the caller's (nb, n, L) after the last
    pass."""
    L = spec.n_limbs
    F, M, P, Qn = _pass_dims(plan, d)
    if d == 0:
        y = x.reshape(nb, F, M, L).transpose(0, 1).to(torch.int64)
        if plan.tin is not None:
            y = fc.mul64(spec, y, _from_mont(spec, plan.tin)[:, None])
    else:
        y = x.reshape(F, nb, M, L)
    y = col_pass_plain(spec, y.reshape(F, nb * M, L), _from_mont(spec, plan.stage_tws[d]))
    y = y.reshape(F, nb, M, L)
    if plan.tout[d] is not None:
        y = fc.mul64(spec, y.to(torch.int64), _from_mont(spec, plan.tout[d])[:, None])
    if d < len(plan.Fs) - 1:
        Fn = plan.Fs[d + 1]
        y = y.reshape(F, nb, Fn, Qn, P, L).permute(2, 1, 3, 0, 4, 5)
        return y.reshape(Fn, nb * (plan.n // Fn), L).to(torch.int32)
    return y.transpose(0, 1).reshape(nb, plan.n, L).to(torch.int32)


def fused_pass(spec: FieldSpec, plan: DevicePlan, d: int, x: torch.Tensor, nb: int) -> torch.Tensor:
    """Pass d of the transform of nb polynomials: kernel K3 on the card, the
    plain version on the CPU.  In and out as ``fused_pass_plain``, except
    that on the card the intermediate (F_{d+1}, nb n / F_{d+1}, L/2) holds
    packed words (canonical domain, not Montgomery): of values below 2p in
    the lazy mode, where 4p < R, and of canonical values, the plain
    version's words bit for bit, in the strict mode, where only 2p < R
    (BLS12-381's Fr; ``_cuda.reduction_consts``)."""
    if x.dtype != torch.int32:
        raise TypeError("fused_pass expects torch.int32")
    if x.device.type == "cpu" and plan.stage_tws[d].device.type == "cpu":
        return fused_pass_plain(spec, plan, d, x, nb)
    if x.device.type != "cuda" or plan.stage_tws[d].device != x.device:
        raise ValueError(f"fused_pass operands on {x.device} and {plan.stage_tws[d].device}")
    L = spec.n_limbs
    NW = L // 2
    F, M, P, Qn = _pass_dims(plan, d)
    last = d == len(plan.Fs) - 1
    want = (nb, plan.n, L) if d == 0 else (F, nb * M, NW)
    if tuple(x.shape) != want or not x.is_contiguous():
        raise ValueError(f"fused_pass {d}: expected contiguous {want}, got {tuple(x.shape)}")
    if F > 256:
        raise ValueError("fused_pass supports F <= 256")
    shape = (nb, plan.n, L) if last else (plan.Fs[d + 1], nb * (plan.n // plan.Fs[d + 1]), NW)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    if nb == 0:
        return out
    tin = plan.tin if d == 0 else None
    tout = plan.tout[d]
    strict, consts = _cuda.reduction_consts(spec)
    fn = _cuda.lib("ntt_col_pass").zk_ntt_fused_pass
    err = fn(
        L, x.data_ptr(), out.data_ptr(), F.bit_length() - 1, nb, M,
        P.bit_length() - 1, max(Qn, 1).bit_length() - 1, int(d == 0), int(last),
        plan.stage_tws[d].data_ptr(),
        None if tin is None else tin.data_ptr(),
        None if tout is None else tout.data_ptr(),
        int(strict), consts, _cuda.stream_ptr(x),
    )
    _cuda.check(err, "ntt_col_pass")
    _cuda.count(_cuda.instance("ntt_col_pass", strict=strict))
    return out


# ---------------------------------------------------------------------------
# the multi-pass driver
# ---------------------------------------------------------------------------


def transform(spec: FieldSpec, plan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Run the (i)NTT described by ``plan`` on x of shape (..., n, L): one
    fused pass per factor (D launches of K3 on the card, nothing else).

    Leading batch axes fold outermost into the column axis (they transform
    independently and identically).
    """
    L = spec.n_limbs
    n = plan.n
    batch = x.shape[:-2]
    if tuple(x.shape[-2:]) != (n, L):
        raise ValueError(f"transform of size {n}: got {tuple(x.shape)}")
    nb = 1
    for s in batch:
        nb *= s
    y = x if x.device.type == "cpu" else x.contiguous()
    y = y.reshape(nb, n, L)
    for d in range(len(plan.Fs)):
        y = fused_pass(spec, plan, d, y, nb)
    return y.reshape(*batch, n, L)


class MrPlanSet:
    """fft / ifft / coset_fft / coset_ifft host plans for one domain size."""

    def __init__(self, fwd, inv, coset_fwd, coset_inv):
        self.fwd, self.inv = fwd, inv
        self.coset_fwd, self.coset_inv = coset_fwd, coset_inv


def build_plan_set(dom) -> MrPlanSet:
    return MrPlanSet(
        build_plan(dom, inverse=False, coset=False),
        build_plan(dom, inverse=True, coset=False),
        build_plan(dom, inverse=False, coset=True),
        build_plan(dom, inverse=True, coset=True),
    )
