"""Mixed-radix multi-pass NTT: numpy plans, the K3 pass kernel, the driver.

The algorithm is that of ``zkt_plonk_tpu/ops/ntt_mr.py`` (Bailey's four-step
method generalized to D factors, n = F1*...*FD): pass d runs F_d-point DIT
NTTs down the rows of an (F_d, M_d) array whose rows are taken in
bit-reversed order, then multiplies by the inter-pass twiddles
w^(P_d t c) and transposes the next factor to the row axis.  ``factorize``,
``build_plan``, ``_stage_tws`` and the compact ``Tbl`` tables come across
unchanged as numpy, extended to the single-pass case (n <= 2^8, where 1/n
is an epilogue table instead of part of an inter-pass table).

The port keeps elements in the last axis, ``(F, M, L)``, and expands the
compact tables into full ``(rows, M, L)`` device tables once per plan
(``DevicePlan``).  Each pass is one launch of kernel K3 (``ntt_col_pass``,
the row gather included) and one K1 launch per table multiply.
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
# device plan: full tables, built once
# ---------------------------------------------------------------------------


class DevicePlan:
    """One direction of one size on one device: per-pass stage twiddles
    (F, L) and full (rows, M, L) table products (None where absent)."""

    def __init__(self, spec: FieldSpec, plan: MrPlan, device: torch.device):
        self.n = plan.n
        self.factors = plan.factors
        Fs = [1 << f for f in plan.factors]
        self.Fs = Fs
        self.stage_tws = [
            torch.from_numpy(tw[:, :, 0].astype(np.int32)).to(device) for tw in plan.stage_tws
        ]
        self.post = [
            _table_product(spec, ts, plan.n // Fs[d], device) for d, ts in enumerate(plan.post)
        ]
        pro = _table_product(spec, plan.pro, plan.n // Fs[0], device)
        if pro is not None and pro.shape[0] > 1:
            # the kernel gathers rows on load, so the prologue applies before
            # it in natural row order (bit reversal is an involution)
            pro = pro.index_select(0, torch.from_numpy(plan.bitrevs[0].astype(np.int64)).to(device))
        self.pro = pro
        self.epi = _table_product(spec, plan.epi, plan.n // Fs[-1], device)


def _table_product(spec, tbls: List[Tbl], M: int, device) -> Optional[torch.Tensor]:
    full = None
    for t in tbls:
        arr = torch.from_numpy(t.expand(M).astype(np.int32)).to(device)
        full = arr if full is None else fd.mul(spec, full, arr)
    return None if full is None else full.contiguous()


# ---------------------------------------------------------------------------
# K3: one radix-F column pass
# ---------------------------------------------------------------------------


def col_pass_plain(spec: FieldSpec, x: torch.Tensor, stage_tws: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3: rows gathered in bit-reversed order,
    then all log2 F DIT stages along axis 0 of (F, M, L), int64 limb math."""
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


def col_pass(spec: FieldSpec, x: torch.Tensor, stage_tws: torch.Tensor) -> torch.Tensor:
    """One radix-F pass over x (F, M, L): kernel K3 on the card, the plain
    version on the CPU."""
    if x.dtype != torch.int32 or stage_tws.dtype != torch.int32:
        raise TypeError("col_pass expects torch.int32 limbs")
    F, M, L = x.shape
    if L != spec.n_limbs or tuple(stage_tws.shape) != (F, L) or F & (F - 1):
        raise ValueError(f"bad col_pass shapes {tuple(x.shape)} / {tuple(stage_tws.shape)}")
    if x.device.type == "cpu" and stage_tws.device.type == "cpu":
        return col_pass_plain(spec, x, stage_tws)
    if x.device.type != "cuda" or stage_tws.device != x.device:
        raise ValueError(f"col_pass operands on {x.device} and {stage_tws.device}")
    logF = F.bit_length() - 1
    if logF > 8:
        raise ValueError("col_pass supports F <= 256")
    x = x.contiguous()
    tw = stage_tws.contiguous()
    out = torch.empty_like(x)
    if M == 0:
        return out
    fn = _cuda.lib("ntt_col_pass").zk_ntt_col_pass
    err = fn(
        L, x.data_ptr(), out.data_ptr(), logF, M, tw.data_ptr(),
        _cuda.field_consts(spec), _cuda.stream_ptr(x),
    )
    _cuda.check(err, "ntt_col_pass")
    _cuda.launches["ntt_col_pass"] += 1
    return out


# ---------------------------------------------------------------------------
# the multi-pass driver
# ---------------------------------------------------------------------------


def _mul_table(spec, x, tbl, nb):
    """x (F, nb*M, L) times a (rows, M, L) table broadcast over batches."""
    F, W, L = x.shape
    rows, M, _ = tbl.shape
    y = fd.mul(spec, x.reshape(F, nb, M, L), tbl.reshape(rows, 1, M, L))
    return y.reshape(F, W, L)


def transform(spec: FieldSpec, plan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Run the (i)NTT described by ``plan`` on x of shape (..., n, L).

    Leading batch axes fold outermost into the column axis (they transform
    independently and identically).
    """
    L = spec.n_limbs
    n = plan.n
    Fs = plan.Fs
    D = len(Fs)
    batch = x.shape[:-2]
    nb = 1
    for s in batch:
        nb *= s
    C = n // Fs[0]
    x = x.reshape(nb, Fs[0], C, L).permute(1, 0, 2, 3).reshape(Fs[0], nb * C, L)
    Q = n
    P = 1
    for d in range(D):
        F = Fs[d]
        Q //= F
        if d == 0 and plan.pro is not None:
            x = _mul_table(spec, x, plan.pro, nb)
        x = col_pass(spec, x, plan.stage_tws[d])
        if plan.post[d] is not None:
            x = _mul_table(spec, x, plan.post[d], nb)
        if d == D - 1 and plan.epi is not None:
            x = _mul_table(spec, x, plan.epi, nb)
        if d < D - 1:
            # (F_d, nb*M_d, L) -> (F_{d+1}, nb*M_{d+1}, L)
            Fn = Fs[d + 1]
            Qn = Q // Fn
            x = x.reshape(F, nb, Fn, Qn, P, L).permute(2, 1, 3, 0, 4, 5)
            x = x.reshape(Fn, nb * Qn * F * P, L)
        P *= F
    M = n // Fs[-1]
    return x.reshape(Fs[-1], nb, M, L).permute(1, 0, 2, 3).reshape(*batch, n, L)


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
