"""Host-to-device staging of limbs (``fields.device.upload`` and the
prover's ``RoundSchedule.stack_rows``/``vec``/``blinders``) on the CPU:
16-bit limbs widened on the device equal the int32 limbs of
``ints_to_array`` bit for bit, and the recorder counts 2 bytes a limb.
The pinned copy on a card is checked by ``chip_smoke.py``'s withdraw
phase."""

import random

import numpy as np
import pytest
import torch

from zkt_plonk_tpu_torch.fields import BLS12_381_FR, BN254_FR, ints_to_array, make_spec
from zkt_plonk_tpu_torch.fields import device as fd
from zkt_plonk_tpu_torch.proof_system.prover import RoundSchedule
from zkt_plonk_tpu_torch.utils import profiling

FIELDS = {"bn254_fr": BN254_FR, "bls12_381_fr": BLS12_381_FR}
CPU = torch.device("cpu")


def reference(cols, n_limbs):
    """The int32 limbs as the port staged them before: uint32 limbs, stacked,
    cast to int32."""
    return torch.from_numpy(np.stack([ints_to_array(c, n_limbs) for c in cols]).astype(np.int32))


def edge_values(p, n_limbs, rng, rows):
    """0, 1, p - 1, a value below p with every limb but the top one >= 0x8000
    (no value below these moduli has them all: their top limbs are under
    0x8000), then random values below p."""
    top = 16 * (n_limbs - 1)
    trap = sum((0x8000 | (0x0123 * i)) << (16 * i) for i in range(n_limbs - 1))
    trap += ((p >> top) - 1) << top
    assert trap < p
    vals = [0, 1, p - 1, trap]
    return vals + [rng.randrange(p) for _ in range(rows - len(vals))]


class Stub(RoundSchedule):
    """The staging half of a prover: a spec, a device and a row block."""

    def __init__(self, params, row_block):
        self.spec = make_spec(params)
        self.p = params.modulus
        self.device = CPU
        self.row_block = row_block


@pytest.mark.parametrize("field", FIELDS)
def test_upload_equals_the_int32_limbs(field):
    params = FIELDS[field]
    spec = make_spec(params)
    rng = random.Random(1)
    cols = [edge_values(params.modulus, spec.n_limbs, rng, 64) for _ in range(3)]
    got = fd.upload(spec.n_limbs, cols, CPU)
    assert got.dtype == torch.int32 and got.shape == (3, 64, spec.n_limbs)
    assert torch.equal(got, reference(cols, spec.n_limbs))


@pytest.mark.parametrize("field", FIELDS)
def test_upload_keeps_every_limb_of_0xffff(field):
    """The widest value the limbs hold, every limb 0xffff: a limb read as
    a signed 16-bit number would widen to -1."""
    n_limbs = make_spec(FIELDS[field]).n_limbs
    cols = [[(1 << (16 * n_limbs)) - 1, 1 << (16 * n_limbs - 1)]]
    got = fd.upload(n_limbs, cols, CPU)
    assert torch.equal(got, reference(cols, n_limbs))
    assert int(got.min()) >= 0 and int(got[0, 0].min()) == 0xFFFF


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("block", ["whole", "body", "tail"])
def test_stack_rows_takes_the_row_block(field, block):
    """A prover's rows as ``ShardedProver`` takes them at D = 2: the first
    or the second half of each column, or all of it."""
    params = FIELDS[field]
    n = 32
    lo, hi = {"whole": (0, n), "body": (0, n // 2), "tail": (n // 2, n)}[block]
    sched = Stub(params, (lo, hi))
    rng = random.Random(2)
    cols = [edge_values(params.modulus, sched.spec.n_limbs, rng, n) for _ in range(2)]
    got = sched.stack_rows(cols)
    assert torch.equal(got, reference([c[lo:hi] for c in cols], sched.spec.n_limbs))
    assert torch.equal(sched.rows(cols[1]), got[1])


@pytest.mark.parametrize("field", FIELDS)
def test_scalars_and_blinders(field):
    """``vec`` reduces mod p; ``blinders`` draws its scalars in the order
    the one-row-at-a-time staging drew them, zeros after each row's count."""
    params = FIELDS[field]
    p = params.modulus
    sched = Stub(params, (0, 8))
    L = sched.spec.n_limbs
    vals = [0, 1, p - 1, p, p + 5, -1, 3 * p + 7]
    assert torch.equal(sched.vec(vals), reference([[v % p for v in vals]], L)[0])

    counts = [0, 3, 2]
    got = sched.blinders(random.Random(3), counts)
    rng = random.Random(3)
    rows = [[rng.randrange(p) for _ in range(k)] + [0] * (4 - k) for k in counts]
    assert got.shape == (3, 4, L)
    assert torch.equal(got, torch.stack([reference([r], L)[0] for r in rows]))


@pytest.mark.parametrize("k,rows", [(1, 1), (3, 40), (7, 16)])
def test_the_recorder_counts_two_bytes_a_limb(k, rows):
    """One copy a call, of 2 x rows x L x k bytes; none pinned on the CPU."""
    n_limbs = make_spec(BN254_FR).n_limbs
    rng = random.Random(4)
    cols = [[rng.randrange(BN254_FR.modulus) for _ in range(rows)] for _ in range(k)]
    before = profiling.snapshot()
    fd.upload(n_limbs, cols, CPU)
    after = profiling.snapshot()
    assert after["h2d_copies"] - before["h2d_copies"] == 1
    assert after["h2d_bytes"] - before["h2d_bytes"] == 2 * rows * n_limbs * k
    assert after["h2d_pinned_bytes"] == before["h2d_pinned_bytes"]


@pytest.mark.parametrize("field", FIELDS)
def test_constant_is_one_upload(field):
    """``fd.constant`` stages its value the same way: one copy of 2L bytes."""
    spec = make_spec(FIELDS[field])
    v = FIELDS[field].modulus - 2
    before = profiling.snapshot()
    got = fd.constant(spec, v, (3,), device=CPU)
    after = profiling.snapshot()
    assert got.shape == (3, spec.n_limbs)
    assert torch.equal(got, reference([[v] * 3], spec.n_limbs)[0])
    assert after["h2d_bytes"] - before["h2d_bytes"] == 2 * spec.n_limbs
