"""The request generator, the reference and whole runs, on the port's CPU
path at the smallest withdraw (HEIGHT=1, NOTE_INPUTS=1, TABLE_SIZE=64:
n = 2^13; a proof takes about two minutes there), and the control and the
fixed-blinders fault on the card at the cells' own sizes.

One module fixture sets the port up and proves the first request once;
the fault runs replay that proof through a patched ``Prover.prove``, so
they drive the whole run (window, judgement, result) in seconds.
"""

import copy
import json
import os
import random

import pytest

from benchmark import run as bench_run
from benchmark.core import inputs, spec
from benchmark.reference import plonk_kzg
from benchmark.reference.frozen.gadgets.merkle_tree import MerkleTree, MerkleTreeStore
from benchmark.reference.frozen.hashing.poseidon.spec import Poseidon

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED = 2**33 + 12345  # past 32 bits: a seed is any whole number


def load(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


TINY_CELL = {"name": "tiny.serial", "config": "tiny_withdraw", "traffic": "tiny_serial",
             "chips": 1}


@pytest.fixture(scope="module")
def tiny():
    """(setup, the first run's result, the Proof objects it made)."""
    import torch

    from zkt_plonk_tpu_torch.proof_system.prover import Prover

    torch.set_num_threads(4)
    setup = bench_run.Setup(TINY_CELL, load("tiny_withdraw.json"), load("tiny_serial.json"),
                            SEED, "cpu")
    made = []
    inner = Prover.prove

    def recording(self, *a, **kw):
        made.append(inner(self, *a, **kw))
        return made[-1]

    Prover.prove = recording
    setup.port.close = lambda: None  # the module's later runs reuse the keys
    try:
        result = bench_run.run(setup, 0.0, False, report=lambda line: None)
    finally:
        Prover.prove = inner
    return setup, result, made


# -- the generator -----------------------------------------------------------

def test_the_same_seed_gives_the_same_deployment():
    cfg, mix = load("tiny_withdraw.json"), load("tiny_serial.json")
    a, b = inputs.make(cfg, mix, SEED), inputs.make(cfg, mix, SEED)
    assert a == b
    assert inputs.make(cfg, mix, SEED + 1).tau != a.tau


@pytest.mark.parametrize("height,notes,pool", [(1, 1, 2), (3, 2, 3), (5, 3, 4)])
def test_tree_paths_equal_the_incremental_tree(height, notes, pool):
    cfg = dict(load("tiny_withdraw.json"), height=height, note_inputs=notes)
    d = inputs.make(cfg, dict(load("tiny_serial.json"), pool=pool), SEED)
    hasher = Poseidon(plonk_kzg.poseidon_constants("bn254", 4), native=True)
    tree = MerkleTree(hasher, MerkleTreeStore(height=height))
    leaves = []
    for req in d.requests:
        for ident, amount, secret in zip(req.identifiers, req.amounts, req.secrets):
            leaves.append(hasher.hash(None, [ident, amount, hasher.hash(None, [secret])]))
    for leaf in leaves:
        tree.add_leaf(leaf)
    for req in d.requests:
        assert req.root == tree.root
        assert req.paths == [tree.merkle_path(i) for i in req.leaf_indices]


def test_the_generator_gives_what_the_port_circuit_makes_public(tiny):
    from zkt_plonk_tpu_torch.cs import ConstraintSystem, LookupTable

    setup, _, _ = tiny
    table = LookupTable(setup.deployment.table, size=setup.config["table_size"])
    for req, circuit in zip(setup.deployment.requests, setup.circuits):
        cs = ConstraintSystem(plonk_kzg.CURVES["bn254"].r, setup=False, lookup_table=table)
        circuit.synthesize(cs)
        assert cs.proving.pi_values() == req.public_inputs


# -- the reference -------------------------------------------------------------

def test_the_reference_derives_the_port_verifier_key(tiny):
    setup, _, _ = tiny
    vk = plonk_kzg.verifier_key(setup.config, setup.deployment.tau)
    pvk = setup.port.compiled.vk
    assert (vk.n, vk.pi_pos, vk.omega) == (pvk.n, pvk.pi_pos, pvk.domain_gen)
    for name in plonk_kzg.POLY_ORDER:
        assert vk.commitments[name] == (None if pvk.commitments[name] is None else
                                        tuple(int(c) for c in pvk.commitments[name])), name


def test_the_reference_accepts_the_run_and_refuses_tampering(tiny):
    setup, result, made = tiny
    assert result["correct"] is True
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        "refused": 0, "repeated": 0, "failed": 0}
    d = setup.deployment
    answer = setup.port.answer(made[0])
    vk = plonk_kzg.verifier_key(setup.config, d.tau)
    plonk_kzg.verify(vk, answer, d.requests[0].public_inputs)
    for i in range(len(d.requests[0].public_inputs)):
        bad = list(d.requests[0].public_inputs)
        bad[i] += 1
        with pytest.raises(plonk_kzg.Rejected):
            plonk_kzg.verify(vk, answer, bad)
    with pytest.raises(plonk_kzg.Rejected):
        plonk_kzg.verify(vk, answer, d.requests[1].public_inputs)
    # an evaluation changed, a commitment's sign flipped, a wrong tau
    nq = 32
    flipped = bytearray(answer)
    flipped[-1] ^= 1
    with pytest.raises(plonk_kzg.Rejected):
        plonk_kzg.verify(vk, bytes(flipped), d.requests[0].public_inputs)
    flipped = bytearray(answer)
    flipped[nq - 1] ^= 0x80
    with pytest.raises(plonk_kzg.Rejected):
        plonk_kzg.verify(vk, bytes(flipped), d.requests[0].public_inputs)
    wrong = plonk_kzg.verifier_key(setup.config, d.tau + 1)
    with pytest.raises(plonk_kzg.Rejected):
        plonk_kzg.verify(wrong, answer, d.requests[0].public_inputs)


# -- whole runs with the timed path broken underneath ----------------------------

def replay_run(tiny, fault, seconds):
    """A whole run on the tiny setup whose ``Prover.prove`` returns
    ``fault(k, proof)`` at its k-th call, ``proof`` being the fixture's real
    proof of request 0."""
    from zkt_plonk_tpu_torch.proof_system.prover import Prover

    setup, _, made = tiny
    setup.warm_answers = []
    calls = []
    inner = Prover.prove

    def broken(self, composer, transcript, rng):
        calls.append(None)
        return fault(len(calls) - 1, made[0])

    Prover.prove = broken
    try:
        return bench_run.run(setup, seconds, False, report=lambda line: None)
    finally:
        Prover.prove = inner


def test_an_answer_altered_where_it_is_made_is_not_correct(tiny):
    def altered(k, proof):
        out = copy.deepcopy(proof)
        out.evaluations.a = (out.evaluations.a + 1) % plonk_kzg.CURVES["bn254"].r
        return out

    result = replay_run(tiny, altered, seconds=0.0)
    assert result["correct"] is False
    assert result["checks"]["refused"]["value"] == result["attempted"] == 1


def test_a_stale_answer_is_not_correct(tiny):
    # every call returns request 0's proof: the pool's other requests are
    # refused, and every answer after the first repeats it
    result = replay_run(tiny, lambda k, proof: proof, seconds=0.5)
    n = result["attempted"]
    assert n >= 2 and result["correct"] is False
    assert result["checks"]["repeated"]["value"] == n - 1
    assert result["checks"]["refused"]["value"] == n - (n + 2) // 3


def test_a_request_that_raises_is_not_correct(tiny):
    def raising(k, proof):
        if k == 1:
            raise RuntimeError("kernel launch failed")
        return proof

    result = replay_run(tiny, raising, seconds=0.3)
    assert result["attempted"] >= 2 and result["failed"] == 1
    assert result["checks"]["failed"]["value"] == 1 and result["correct"] is False


def fixed_blinders_run(setup, seconds):
    """A whole run whose prover ignores the rng it is given and draws every
    blinder from one fixed rng (``Prover.prove`` patched), with one warm-up
    proof."""
    from zkt_plonk_tpu_torch.proof_system.prover import Prover

    mix, inner = setup.traffic, Prover.prove
    setup.traffic = dict(mix, warmup=1)
    Prover.prove = lambda self, composer, transcript, rng: inner(
        self, composer, transcript, random.Random(0))
    try:
        return bench_run.run(setup, seconds, False, report=lambda line: None)
    finally:
        Prover.prove = inner
        setup.traffic = mix


def test_blinders_that_are_not_fresh_are_not_correct(tiny):
    # every proof verifies; the warm-up's request 0, proved again first in
    # the window, gives the same bytes
    result = fixed_blinders_run(tiny[0], 0.0)
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        "refused": 0, "repeated": 1, "failed": 0}
    assert result["correct"] is False


# -- the control and a fault, on the card at the cells' own sizes -------------------

# The control breaks the transcript the configuration states, whose
# Fiat-Shamir challenges the deployment's verifiers replay: BN254 proves
# under the Ethereum transcript; BLS12-381, whose 381-bit coordinates the
# Ethereum transcript cannot encode, under Merlin with 64-byte coordinates.
CONTROLS = {
    "bn254_kzg_withdraw.serial1": {"transcript": "ethereum"},
    "bls12_381_kzg_withdraw.serial1": {"coord_bytes": 64},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROLS))
@pytest.mark.parametrize("seed", [3_900_000_001, 3_900_000_002, 3_900_000_003])
def test_the_control_is_not_correct(card, cell, seed):
    """The control at the cell's size and load: every proof refused."""
    config = spec.config(spec.cell(cell)["config"])
    setup = bench_run.cell_setup(cell, seed, program_config=dict(config, **CONTROLS[cell]))
    lines = []
    result = bench_run.run(setup, spec.benchmark()["run_seconds"], False, report=lines.append)
    print(lines[-1])
    assert result["correct"] is False
    assert result["checks"]["refused"]["value"] == result["attempted"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROLS))
@pytest.mark.parametrize("seed", [3_900_000_011, 3_900_000_012, 3_900_000_013])
def test_blinders_that_are_not_fresh_are_not_correct_on_the_card(card, cell, seed):
    """Fixed blinders at the cell's size, in a 10 s window: every proof
    accepted, and each request proved twice repeated."""
    result = fixed_blinders_run(bench_run.cell_setup(cell, seed), 10.0)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    print(json.dumps({"cell": cell, "seed": seed, "attempted": result["attempted"],
                      "checks": checks}))
    assert checks["refused"] == checks["failed"] == 0 and checks["repeated"] >= 1
    assert result["correct"] is False
