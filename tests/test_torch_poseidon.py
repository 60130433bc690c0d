"""The port's device Poseidon (``hashing/poseidon/device.py``) on the CPU,
where every add and multiply runs kernel K1's plain version, against the
JAX package's device Poseidon and the host hasher.  Every check is exact:
equal ints, equal limbs.
"""

import numpy as np
import pytest
import torch

from zkt_plonk_tpu.fields import BN254_FR as JBN254_FR
from zkt_plonk_tpu.fields.limbs import make_spec as jmake_spec
from zkt_plonk_tpu.hashing import Poseidon as JPoseidon
from zkt_plonk_tpu.hashing import bn254_constants as jbn254_constants
from zkt_plonk_tpu.hashing.poseidon import device as jdevice
from zkt_plonk_tpu.hashing.poseidon import optimized as joptimized
from zkt_plonk_tpu_torch.fields import BN254_FR, make_spec
from zkt_plonk_tpu_torch.hashing import Poseidon, bn254_constants
from zkt_plonk_tpu_torch.hashing.poseidon import device as pdevice


def _rows(width):
    """``tests/test_poseidon.py:88-105``: 6 full rows and one short row."""
    arity = width - 1
    return [[i * 17 + j + 1 for j in range(arity)] for i in range(6)] + [[5]]


@pytest.mark.parametrize("width", [3, 4])
def test_hash_batch_matches_jax_and_host(width):
    rows = _rows(width)
    got = pdevice.hash_batch_device(bn254_constants(width), rows, device="cpu")
    assert got == jdevice.hash_batch_device(jbn254_constants(width), rows)
    assert got == Poseidon.hash_many_native(bn254_constants(width), rows)
    assert got == JPoseidon.hash_many_native(jbn254_constants(width), rows)


@pytest.mark.parametrize("width", [3, 4])
def test_tables_match_jax(width):
    tabs = pdevice.device_tables(make_spec(BN254_FR), bn254_constants(width), device="cpu")
    jtabs = jdevice.device_tables(jmake_spec(JBN254_FR), jbn254_constants(width))
    for key in ("rc", "mds", "tag"):
        np.testing.assert_array_equal(tabs[key].numpy(), np.asarray(jtabs[key]).astype(np.int32))


def test_permute_random_states_match_jax_host():
    """Random full states (not only sponge inputs) through the permutation,
    against the JAX package's host permutation of the whole state."""
    const = bn254_constants(4)
    spec = make_spec(BN254_FR)
    p = spec.modulus
    gen = np.random.default_rng(5)
    states = [[int.from_bytes(gen.bytes(32), "little") % p for _ in range(4)] for _ in range(5)]
    states.append([0, 0, 0, 0])
    states.append([p - 1] * 4)
    arr = np.stack([spec.encode([s[i] for s in states]) for i in range(4)]).astype(np.int32)
    tabs = pdevice.device_tables(spec, const, device="cpu")
    out = pdevice.permute_batch(spec, tabs["rc"], tabs["mds"], torch.from_numpy(arr),
                                const.full_rounds // 2, const.partial_rounds)
    got = [spec.decode(out[i].numpy()) for i in range(4)]
    for b, s in enumerate(states):
        want = joptimized.permute_optimized(jbn254_constants(4), s)
        assert [got[i][b] for i in range(4)] == want


def test_initial_state_pads_short_rows():
    spec = make_spec(BN254_FR)
    const = bn254_constants(4)
    st = pdevice.initial_state(spec, const, [[1, 2, 3], [7]], "cpu")
    assert st.shape == (4, 2, spec.n_limbs) and st.dtype == torch.int32
    assert [spec.decode(st[i].numpy()) for i in range(4)] == [
        [const.domain_tag] * 2, [1, 7], [2, 0], [3, 0]]


def test_cuda_asked_for_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError):
        pdevice.hash_batch_device(bn254_constants(4), [[1, 2, 3]])
