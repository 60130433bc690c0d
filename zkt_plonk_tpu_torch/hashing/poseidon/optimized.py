"""Poseidon optimized-path machinery: sparse MDS factorization + constant
compression, and the optimized native permutation that consumes them.

Rebuild of the reference's neptune-derived preprocessing
(``plonk-hashing/src/hasher/poseidon/mds.rs:9-180``,
``preprocessing.rs:10-88``, ``matrix.rs``): the per-partial-round dense
MDS multiply (width^2 muls) factors into ONE dense pre-sparse multiply up
front plus a sparse multiply (2*width - 1 muls) per partial round, and
round constants are pushed back through the linear layers so constant
adds happen only after S-boxes.

Orientation: states are ROW vectors, applied as ``state' = state x M``
(``right_apply``) — matching both the reference and ``spec.py``'s
``_product_mds`` (result[j] = sum_i state[i] * mds[i][j]).

All math is host-side ``int`` (these are per-hash-width preprocessing
artifacts, cached per constants object).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

from .constants import PoseidonConstants

Matrix = List[List[int]]


# ---------------------------------------------------------------------------
# matrix algebra over F_p (reference ``matrix.rs``, the subset the
# optimization needs: identity/minor/transpose-free right-apply/matmul/
# Gaussian inversion)
# ---------------------------------------------------------------------------


def identity(n: int) -> Matrix:
    return [[1 if i == j else 0 for j in range(n)] for i in range(n)]


def matmul(a: Matrix, b: Matrix, p: int) -> Matrix:
    n, m, k = len(a), len(b[0]), len(b)
    return [
        [sum(a[i][t] * b[t][j] for t in range(k)) % p for j in range(m)]
        for i in range(n)
    ]


def right_apply(v: Sequence[int], m: Matrix, p: int) -> List[int]:
    """Row vector x matrix: out[j] = sum_i v[i] * m[i][j]."""
    n = len(m[0])
    return [sum(v[i] * m[i][j] for i in range(len(v))) % p for j in range(n)]


def minor(m: Matrix, i: int, j: int) -> Matrix:
    return [
        [v for cj, v in enumerate(row) if cj != j]
        for ri, row in enumerate(m)
        if ri != i
    ]


def invert(m: Matrix, p: int) -> Matrix:
    """Gauss-Jordan over F_p; raises if singular."""
    n = len(m)
    aug = [[v % p for v in row] + identity(n)[i] for i, row in enumerate(m)]
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r][col] % p != 0), None)
        if piv is None:
            raise ValueError("matrix is singular")
        aug[col], aug[piv] = aug[piv], aug[col]
        inv_p = pow(aug[col][col], -1, p)
        aug[col] = [v * inv_p % p for v in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(v - f * aug[col][j]) % p for j, v in enumerate(aug[r])]
    return [row[n:] for row in aug]


# ---------------------------------------------------------------------------
# sparse factorization (``mds.rs:66-180``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SparseMatrix:
    """M'' form: dense first row and column, identity minor
    (``mds.rs:121-157``)."""

    w_hat: Tuple[int, ...]  # first column (length width)
    v_rest: Tuple[int, ...]  # first row tail (length width - 1)

    def right_apply(self, v: Sequence[int], p: int) -> List[int]:
        out0 = sum(vi * wi for vi, wi in zip(v, self.w_hat)) % p
        rest = [
            (v[0] * self.v_rest[j - 1] + v[j]) % p for j in range(1, len(v))
        ]
        return [out0] + rest

    def to_matrix(self) -> Matrix:
        n = len(self.w_hat)
        m = identity(n)
        for j, w in enumerate(self.w_hat):
            m[j][0] = w
        for i, v in enumerate(self.v_rest):
            m[0][i + 1] = v
        return m


def derive_mds_matrices(m: Matrix, p: int) -> dict:
    """m -> {m_inv, m_hat, m_hat_inv, m_prime, m_double_prime}
    (``mds.rs:26-41``)."""
    w = len(m)
    m_hat = minor(m, 0, 0)
    m_hat_inv = invert(m_hat, p)
    # m_prime: identity first row/col, minor elsewhere
    m_prime = identity(w)
    for i in range(1, w):
        for j in range(1, w):
            m_prime[i][j] = m[i][j]
    # m_double_prime: first row = [m00, v...]; first col tail = w_hat
    v = m[0][1:]
    w_col = [m[i][0] for i in range(1, w)]
    w_hat_tail = right_apply(w_col, m_hat_inv, p)
    m_dp = identity(w)
    m_dp[0] = [m[0][0]] + list(v)
    for i in range(1, w):
        m_dp[i][0] = w_hat_tail[i - 1]
    return {
        "m_inv": invert(m, p),
        "m_hat": m_hat,
        "m_hat_inv": m_hat_inv,
        "m_prime": m_prime,
        "m_double_prime": m_dp,
    }


def factor_to_sparse_matrixes(
    base: Matrix, n_rounds: int, p: int
) -> Tuple[Matrix, List[SparseMatrix]]:
    """(pre_sparse_matrix, sparse matrices, one per partial round)
    (``mds.rs:162-180``)."""
    curr = base
    acc: List[Matrix] = []
    for _ in range(n_rounds):
        derived = derive_mds_matrices(curr, p)
        acc.append(derived["m_double_prime"])
        curr = matmul(base, derived["m_prime"], p)
    acc.reverse()
    sparse = [
        SparseMatrix(
            w_hat=tuple(row[0] for row in m_dp),
            v_rest=tuple(m_dp[0][1:]),
        )
        for m_dp in acc
    ]
    return curr, sparse


# ---------------------------------------------------------------------------
# constant compression (``preprocessing.rs:10-88``)
# ---------------------------------------------------------------------------


def compress_round_constants(
    width: int,
    full_rounds: int,
    partial_rounds: int,
    round_constants: Sequence[int],
    m_inv: Matrix,
    p: int,
) -> List[int]:
    keys = lambda r: list(round_constants[r * width : (r + 1) * width])
    hf = full_rounds // 2
    res: List[int] = []
    res.extend(keys(0))
    for i in range(hf - 1):
        res.extend(right_apply(keys(i + 1), m_inv, p))

    # partial rounds: work backwards, saving one post-S-box key per round
    partial_keys: List[int] = []
    final_round = hf + partial_rounds
    acc = keys(final_round)
    for i in range(partial_rounds):
        inverted = right_apply(acc, m_inv, p)
        partial_keys.append(inverted[0])
        inverted[0] = 0
        prev = keys(final_round - i - 1)
        acc = [(a + b) % p for a, b in zip(prev, inverted)]
    res.extend(right_apply(acc, m_inv, p))
    while partial_keys:
        res.append(partial_keys.pop())

    for i in range(1, hf):
        res.extend(right_apply(keys(i + hf + partial_rounds), m_inv, p))
    return res


# ---------------------------------------------------------------------------
# the optimized native permutation
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def optimized_artifacts(constants: PoseidonConstants):
    """Per-width preprocessing: compressed constants + factored matrices."""
    p = constants.p
    mds = [list(r) for r in constants.mds]
    m_inv = invert(mds, p)
    compressed = compress_round_constants(
        constants.width,
        constants.full_rounds,
        constants.partial_rounds,
        constants.round_constants,
        m_inv,
        p,
    )
    pre_sparse, sparse = factor_to_sparse_matrixes(
        mds, constants.partial_rounds, p
    )
    return compressed, pre_sparse, sparse


def permute_optimized(constants: PoseidonConstants, state: Sequence[int]) -> List[int]:
    """Optimized round schedule: dense MDS only in full rounds (with ONE
    pre-sparse multiply at the first-half boundary), a sparse multiply +
    single constant add per partial round.  Bit-identical to the
    unoptimized schedule of ``spec.py`` (tested)."""
    p = constants.p
    width = constants.width
    hf = constants.half_full_rounds
    rp = constants.partial_rounds
    mds = [list(r) for r in constants.mds]
    compressed, pre_sparse, sparse = optimized_artifacts(constants)

    sbox = lambda x: pow(x, 5, p)
    off = 0
    state = [(s + compressed[off + i]) % p for i, s in enumerate(state)]
    off += width

    for r in range(hf):
        state = [sbox(s) for s in state]
        state = [(s + compressed[off + i]) % p for i, s in enumerate(state)]
        off += width
        state = right_apply(state, pre_sparse if r == hf - 1 else mds, p)

    for i in range(rp):
        state[0] = (sbox(state[0]) + compressed[off]) % p
        off += 1
        state = sparse[i].right_apply(state, p)

    for r in range(hf):
        state = [sbox(s) for s in state]
        if r < hf - 1:
            state = [(s + compressed[off + i]) % p for i, s in enumerate(state)]
            off += width
        state = right_apply(state, mds, p)

    assert off == len(compressed)
    return state
