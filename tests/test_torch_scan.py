"""The port's one scan and one tree reduction (``utils/scan.py``) on the CPU.

``scan`` (prefix and, with ``reverse``, suffix) and ``tree_reduce`` over
the ops the port gives them, against references on the host:

* field add and mul on BN254 Fr (the plain version of kernel K1), against
  Python ints mod r;
* the complete EC add (the plain version of kernel K4) on BN254 (L = 16)
  and BLS12-381 (L = 24) points, projective with random Z and one
  identity, against the host curve's affine sums, compared as host affine
  points;

at lengths 1, 2, 5 and 8, along axis 0 and along the row axis just above
the element: -2 for field limbs (the prover's row axis), -3 for points
(axis 1 of the MSM's bucket scan).
"""

import functools
import random

import numpy as np
import pytest
import torch

from zkt_plonk_tpu_torch.curves import curve_host as ch
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields import device as fd
from zkt_plonk_tpu_torch.fields.limbs import array_to_ints, ints_to_array
from zkt_plonk_tpu_torch.ops import ec
from zkt_plonk_tpu_torch.utils.scan import scan, tree_reduce

COLS = 2  # a batch axis beside the scanned one


class FieldCase:
    """k x COLS random BN254 Fr elements, with 0 and r - 1 among them."""

    def __init__(self, ctx, kind, k, rng):
        self.spec = ctx.fr_spec
        r = self.spec.modulus
        vals = [[rng.randrange(r) for _ in range(COLS)] for _ in range(k)]
        vals[0][0] = r - 1
        if k > 2:
            vals[2][1] = 0
        self.vals = vals
        self.host = {"add": lambda a, b: (a + b) % r, "mul": lambda a, b: a * b % r}[kind]
        fn = {"add": fd.add, "mul": fd.mul}[kind]
        self.op = lambda a, b: fn(self.spec, a, b)
        self.inner_axis = -2

    def tensor(self):
        """(k, COLS, L)."""
        flat = [v for row in self.vals for v in row]
        arr = ints_to_array(flat, self.spec.n_limbs).astype(np.int32)
        return torch.from_numpy(arr).reshape(len(self.vals), COLS, -1)

    def read(self, t):
        """A (COLS, L) row back to COLS ints."""
        return array_to_ints(t.numpy())


class PointCase:
    """k x COLS random multiples of the generator, each scaled to (lX : lY : l) by a
    random l, one of them the identity (0 : 1 : 0)."""

    def __init__(self, ctx, k, rng):
        spec = self.spec = ctx.fq_spec
        p = spec.modulus
        self.Fq = ctx.Fq
        # 64-bit multiples: any points serve, and the host makes them 4x faster
        vals = [[ch.scalar_mul(ctx.g1, rng.randrange(1, 1 << 64)) for _ in range(COLS)] for _ in range(k)]
        vals[k // 2][1] = None
        self.vals = [[None if v is None else (int(v[0]), int(v[1])) for v in row] for row in vals]
        flat = [v for row in self.vals for v in row]
        pts = torch.from_numpy(ec.from_affine_host(spec, flat).astype(np.int32))
        lam = [rng.randrange(1, p) for _ in flat]
        lam = torch.from_numpy(ints_to_array(lam, spec.n_limbs).astype(np.int32))
        self.points = fd.mul(spec, pts, lam[:, None]).reshape(k, COLS, 3, spec.n_limbs)
        b3 = ec.b3_const(spec, ctx.curve.b, device="cpu")
        self.op = lambda a, b: ec.add(spec, b3, a, b)
        self.inner_axis = -3

    def host(self, a, b):
        to_fq = lambda v: None if v is None else (self.Fq(v[0]), self.Fq(v[1]))
        s = ch.add(to_fq(a), to_fq(b))
        return None if s is None else (int(s[0]), int(s[1]))

    def tensor(self):
        """(k, COLS, 3, L)."""
        return self.points

    def read(self, t):
        """A (COLS, 3, L) row back to COLS host affine points."""
        return ec.to_affine_host(self.spec, t)


@functools.lru_cache(maxsize=None)
def _case(op, k):
    """One case per op and length, shared by the tests that read it."""
    rng = random.Random(f"{op}-{k}")
    if op in ("add", "mul"):
        return FieldCase(make_context("bn254"), op, k, rng)
    return PointCase(make_context(op.split("-")[1]), k, rng)


def _fold(host, items):
    acc = items[0]
    for v in items[1:]:
        acc = host(acc, v)
    return acc


OPS = ["add", "mul", "ec-bn254", "ec-bls12_381"]
LENGTHS = [1, 2, 5, 8]
AXES = ["axis0", "inner"]


def _along(case, x, where):
    """x (k, COLS, ...) laid out for ``where``: (tensor, axis)."""
    if where == "axis0":
        return x, 0
    return x.transpose(0, 1).contiguous(), case.inner_axis


@pytest.mark.parametrize("where", AXES)
@pytest.mark.parametrize("k", LENGTHS)
@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("op", OPS)
def test_scan_matches_host_fold(op, reverse, k, where):
    case = _case(op, k)
    x, axis = _along(case, case.tensor(), where)
    got = scan(case.op, x, axis, reverse=reverse)
    assert got.shape == x.shape
    for i in range(k):
        row = case.read(got.select(axis, i))
        for j in range(COLS):
            col = [case.vals[t][j] for t in range(k)]
            want = _fold(case.host, col[i:] if reverse else col[: i + 1])
            assert row[j] == want, (i, j)


@pytest.mark.parametrize("where", AXES)
@pytest.mark.parametrize("k", LENGTHS)
@pytest.mark.parametrize("op", OPS)
def test_tree_reduce_matches_host_fold(op, k, where):
    case = _case(op, k)
    x, axis = _along(case, case.tensor(), where)
    got = tree_reduce(case.op, x, axis)
    want_shape = list(x.shape)
    del want_shape[axis]
    assert list(got.shape) == want_shape
    row = case.read(got)
    for j in range(COLS):
        assert row[j] == _fold(case.host, [case.vals[t][j] for t in range(k)]), j
