"""The port's Merlin transcript and instance config against the JAX package.

Every check is exact: byte-equal challenges from the same call sequence.
(a) merlin's published conformance vector (``tests/test_merlin.py``);
(b) 50 seeded random sequences of ``append_*``/``challenge_scalar`` calls
    (10 cases of 5), with 32- and 48-byte coordinates, give the same
    challenges in both packages;
(c) ``config``: the same defaults and transcript names as the JAX package.
"""

import random

import pytest

from zkt_plonk_tpu import config as jconfig
from zkt_plonk_tpu.transcript.merlin import MerlinTranscript as JMerlin
from zkt_plonk_tpu_torch import config
from zkt_plonk_tpu_torch.fields import BN254_FR
from zkt_plonk_tpu_torch.transcript import EthereumTranscript, MerlinTranscript, Strobe128

P = BN254_FR.modulus


def test_merlin_conformance_vector():
    t = MerlinTranscript("test protocol")
    t._append_message(b"some label", b"some data")
    got = t._challenge_bytes(b"challenge", 32)
    assert got.hex() == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    assert isinstance(t.strobe, Strobe128)


def _random_sequence(rng: random.Random):
    """A list of (method, args) calls, as the prover and verifier make them."""
    def label():
        return "".join(rng.choice("abcdefgh_0123") for _ in range(rng.randrange(0, 12)))

    def point():
        return None if rng.random() < 0.15 else (rng.randrange(P), rng.randrange(P))

    calls = []
    for _ in range(rng.randrange(5, 25)):
        kind = rng.randrange(6)
        if kind == 0:
            calls.append(("append_u64", (label(), rng.randrange(1 << 64))))
        elif kind == 1:
            calls.append(("append_scalar", (label(), rng.randrange(P))))
        elif kind == 2:
            calls.append(("append_scalars", (label(), [rng.randrange(P) for _ in range(rng.randrange(0, 6))])))
        elif kind == 3:
            calls.append(("append_commitment", (label(), point())))
        elif kind == 4:
            calls.append(("append_commitments", (label(), [point() for _ in range(rng.randrange(0, 4))])))
        else:
            calls.append(("challenge_scalar", (label(), rng.choice([31, 31, 16, 64, 200]))))
    calls.append(("challenge_scalar", ("final",)))
    return calls


@pytest.mark.parametrize("case", range(10))
def test_merlin_random_sequences_match_jax(case):
    rng = random.Random(1000 + case)
    for _ in range(5):
        coord_bytes = rng.choice([32, 48])
        proto = "ZKT Plonk" if rng.random() < 0.5 else f"proto-{rng.randrange(100)}"
        calls = _random_sequence(rng)
        ours = MerlinTranscript(proto, coord_bytes=coord_bytes)
        ref = JMerlin(proto, coord_bytes=coord_bytes)
        for method, args in calls:
            got = getattr(ours, method)(*args)
            want = getattr(ref, method)(*args)
            assert got == want, (method, args)
        assert bytes(ours.strobe.state) == bytes(ref.strobe.state)


def test_config_matches_jax():
    ours, ref = config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG
    for name in ("curve", "transcript", "height", "note_inputs", "table_size",
                 "poseidon_width", "max_degree"):
        assert getattr(ours, name) == getattr(ref, name), name
    small, jsmall = config.small_test_config(), jconfig.small_test_config()
    assert (small.height, small.note_inputs, small.table_size, small.poseidon_width,
            small.max_degree) == (jsmall.height, jsmall.note_inputs, jsmall.table_size,
                                  jsmall.poseidon_width, jsmall.max_degree)
    assert config.transcript_factory("merlin") is MerlinTranscript
    assert config.transcript_factory("ethereum") is EthereumTranscript
    with pytest.raises(ValueError):
        config.transcript_factory("sha3")
