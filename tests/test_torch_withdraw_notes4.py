"""The withdraw at NOTE_INPUTS = 4, the reference CLI's largest setting,
on the CPU, held against the JAX package and, as a second witness, the
benchmark's frozen reference.

* The size rule of the configuration ``bn254_kzg_withdraw_h64_n4``
  (HEIGHT=64, NOTE_INPUTS=4, TABLE_SIZE=1024): the JAX package's composer,
  the port's and the benchmark's frozen one count the same gates in setup
  mode, 349,702, with the same public input positions, so the domain is
  n = 2^19; ``compile`` trims the SRS to 4n = 2^21, which the
  configuration's ``srs_degree`` gives and the CLI's default SRS of 2^20
  does not.
* The same configuration at HEIGHT=2, TABLE_SIZE=64 (28,542 gates,
  n = 2^15), on a request of the benchmark's generator
  (``benchmark/core/inputs``): the port's padded setup composer gives the
  JAX package's selectors, sigma evaluations, lookup selector and table
  mask, and the ten columns that the benchmark's plain reference
  (``benchmark/reference/plonk_kzg``) derives its verifier key from; the
  port's proving composer gives the JAX composer's public values and wire
  evaluations; the witness satisfies every gate and lookup (the JAX
  package's ``check_gate``) and every copy with the request's eight public
  inputs (root, 4 nullifiers, amount, new identifier, new leaf), and with
  the 4th nullifier or the root altered the gate that binds it fails.

A proof at n = 2^15 on the port's plain CPU path takes minutes (the SRS
of 2^17 + 1 points and ``compile`` alone about seven), so the proofs of a
4-note withdraw are judged by the benchmark's reference on the card, where
the cell ``bn254_kzg_withdraw_h64_n4.serial1`` proves it at full size.
"""

import copy
import json
import os

import pytest

from benchmark.core import inputs
from benchmark.reference import plonk_kzg
from benchmark.reference.frozen.circuits.withdraw import WithdrawCircuit as FrozenWithdraw
from benchmark.reference.frozen.cs.system import ConstraintSystem as FrozenSystem
from zkt_plonk_tpu.circuits.withdraw import WithdrawCircuit as JWithdrawCircuit
from zkt_plonk_tpu.cs import ConstraintSystem as JConstraintSystem
from zkt_plonk_tpu.cs import LookupTable as JLookupTable
from zkt_plonk_tpu.cs.helper import check_gate as jcheck_gate
from zkt_plonk_tpu.hashing import bn254_constants as jbn254_constants
from zkt_plonk_tpu.hashing.merkle import PoECircuit as JPoECircuit
from zkt_plonk_tpu_torch.circuits.withdraw import WithdrawCircuit
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.cs import ConstraintSystem, LookupTable
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.hashing import bn254_constants
from zkt_plonk_tpu_torch.hashing.merkle import PoECircuit
from zkt_plonk_tpu_torch.plonk import ZKTPlonk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H64_N4 = os.path.join(REPO, "benchmark", "configs", "bn254_kzg_withdraw_h64_n4.json")
CLI_DEFAULT_SRS = 1 << 20  # the reference CLI's default --max-degree
SEED = 2**33 + 419  # past 32 bits, as the benchmark's seeds are
R = plonk_kzg.CURVES["bn254"].r


@pytest.fixture(scope="module")
def h64_n4():
    with open(H64_N4) as f:
        return json.load(f)


def setup_systems(config):
    """The configuration's withdraw circuit synthesized in setup mode by the
    port's, the JAX package's and the frozen composer."""
    port = ConstraintSystem(R, setup=True, lookup_table=LookupTable([], size=config["table_size"]))
    WithdrawCircuit.default(bn254_constants(config["poseidon_width"]), config["note_inputs"],
                            config["height"]).synthesize(port)
    jax = JConstraintSystem(R, setup=True,
                            lookup_table=JLookupTable([], size=config["table_size"]))
    JWithdrawCircuit.default(jbn254_constants(config["poseidon_width"]), config["note_inputs"],
                             config["height"]).synthesize(jax)
    frozen = FrozenSystem(R, table_size=config["table_size"])
    FrozenWithdraw.default(plonk_kzg.poseidon_constants("bn254", config["poseidon_width"]),
                           config["note_inputs"], config["height"]).synthesize(frozen)
    return port, jax, frozen


def srs_of_degree(ctx, degree):
    """A committer key of ``degree`` + 1 points that ``kzg.trim`` can take:
    one identity point repeated as a view, so no memory is spent on it."""
    from zkt_plonk_tpu_torch.ops import ec

    one = ec.identity(ctx.fq_spec, (1,), device="cpu")
    return kzg.CommitterKey(ctx=ctx, powers=one.expand(degree + 1, *one.shape[1:]), b3=None)


def test_h64_n4_is_349702_gates_on_a_domain_of_2_19(h64_n4):
    port, jax, frozen = setup_systems(h64_n4)
    assert port.n == jax.n == frozen.setup.n == 349_702
    assert port.circuit_bound() == jax.circuit_bound() == frozen.circuit_bound() == 1 << 19
    assert port.setup.pp == jax.setup.pp == frozen.setup.pp and len(port.setup.pp) == 8


def test_compile_needs_the_configuration_srs_of_2_21(h64_n4):
    """``compile`` trims the SRS to 4 x the circuit bound: the configuration's
    ``srs_degree`` covers it, the CLI's default 2^20 stops ``compile`` before
    any key is made."""
    inst = ZKTPlonk(curve="bn254", table=LookupTable([], size=h64_n4["table_size"]), device="cpu")
    ctx = make_context("bn254")
    bound = 1 << 19
    assert h64_n4["srs_degree"] == 4 * bound
    ck, _ = kzg.trim(srs_of_degree(ctx, h64_n4["srs_degree"]), None, 4 * bound)
    assert ck.max_degree == 4 * bound
    with pytest.raises(AssertionError, match="circuit_bound"):
        kzg.trim(srs_of_degree(ctx, CLI_DEFAULT_SRS), None, 4 * bound)
    circuit = WithdrawCircuit.default(bn254_constants(h64_n4["poseidon_width"]),
                                      h64_n4["note_inputs"], h64_n4["height"])
    with pytest.raises(AssertionError, match=f"needs {4 * bound}"):
        inst.compile(circuit, srs_of_degree(ctx, CLI_DEFAULT_SRS), None)


@pytest.fixture(scope="module")
def small(h64_n4):
    """The 4-note configuration at HEIGHT=2, TABLE_SIZE=64, a deployment of
    one request from ``inputs.make`` (its 4 notes fill the tree's 4
    leaves), its table in both packages' form, and the setup-mode systems
    of ``setup_systems``."""
    config = dict(h64_n4, height=2, table_size=64)
    deployment = inputs.make(config, {"pool": 1, "withdraw_amount": 120}, SEED)
    table = LookupTable(deployment.table, size=config["table_size"])
    jtable = JLookupTable(deployment.table, size=config["table_size"])
    return config, deployment, table, jtable, setup_systems(config)


def setup_columns(setup, table, n, roots):
    """The ten preprocessed columns, in ``plonk_kzg.POLY_ORDER``, of a setup
    composer of either package padded to ``n`` (a copy: the fixture's stays
    unpadded)."""
    comp = copy.deepcopy(setup)
    comp.pad_to(n)
    sigmas = comp.perm.compute_all_sigma_evals(n, roots, R)
    cols = [comp.q_m, comp.q_l, comp.q_r, comp.q_o, comp.q_c, *sigmas, comp.q_lookup,
            table.masks(n)]
    return [[v % R for v in col] for col in cols]


def test_the_port_setup_columns_equal_jax_at_four_notes(small):
    """The port's padded setup composer: the JAX package's selectors, sigma
    evaluations over the domain x {1, K1, K2}, lookup selector and table
    mask, column for column."""
    config, _, table, jtable, (port, jax, _) = small
    n, _, _, roots, _ = plonk_kzg.setup_columns(config)
    assert port.circuit_bound() == jax.circuit_bound() == n == 1 << 15
    assert port.setup.pp == jax.setup.pp
    got = setup_columns(port.setup, table, n, roots)
    want = setup_columns(jax.setup, jtable, n, roots)
    for name, w, g in zip(plonk_kzg.POLY_ORDER, want, got):
        assert g == w, name


def test_the_reference_derives_the_port_verifier_key_at_four_notes(small):
    """The reference's verifier key commits to its ten columns on its domain
    (``plonk_kzg.setup_columns``); the port's ``proof_system/setup`` commits
    to the setup composer's selectors, the permutation's sigma evaluations
    and the table's mask on the same domain."""
    config, _, table, _, (port, _, _) = small
    n, pi_pos, omega, roots, cols = plonk_kzg.setup_columns(config)
    assert (port.n, n) == (28_542, port.circuit_bound()) and n == 1 << 15
    assert omega == roots[1] and pi_pos == port.setup.pp and len(pi_pos) == 8
    got = setup_columns(port.setup, table, n, roots)
    for name, want, g in zip(plonk_kzg.POLY_ORDER, cols, got):
        assert g == [v % R for v in want], name


def provers(config, req, table, jtable):
    """The port's and the JAX package's proving composers of request ``req``
    (as the benchmark's ``core/port.Port.circuit`` builds the circuit)."""
    out = []
    for Circuit, PoE, constants, System, tab in (
            (WithdrawCircuit, PoECircuit, bn254_constants, ConstraintSystem, table),
            (JWithdrawCircuit, JPoECircuit, jbn254_constants, JConstraintSystem, jtable)):
        h = config["height"]
        circuit = Circuit(
            constants=constants(config["poseidon_width"]), height=h,
            secrets=list(req.secrets), identifiers=list(req.identifiers),
            amount_inputs=list(req.amounts),
            poe_circuits=[PoE(height=h, leaf_index=i, path_elements=list(p))
                          for i, p in zip(req.leaf_indices, req.paths)],
            root=req.root, new_secret=req.new_secret, new_identifier=req.new_identifier,
            withdraw_amount=req.withdraw_amount)
        cs = System(R, setup=False, lookup_table=tab)
        circuit.synthesize(cs)
        out.append(cs.proving)
    return out


def test_the_port_witness_equals_jax_at_four_notes(small):
    """The port's proving composer of a generated 4-note request: the JAX
    composer's public values, in position order, and its wire evaluations."""
    config, deployment, table, jtable, _ = small
    (req,) = deployment.requests
    port, jax = provers(config, req, table, jtable)
    assert port.n == jax.n == 28_542
    assert sorted(port.pi) == sorted(jax.pi)
    assert port.pi_values() == jax.pi_values() == req.public_inputs
    assert port.wire_evals() == jax.wire_evals()


def broken_copies(setup, proving):
    """The gates whose wires the permutation ties to a wire of another
    value: what the copy argument of a proof refuses."""
    wires = proving.wire_evals()
    bad = set()
    for occurrences in setup.perm.slots:
        if len({wires[kind][gate] % R for kind, gate in occurrences}) > 1:
            bad.update(gate for _, gate in occurrences)
    return bad


def test_a_request_of_four_notes_satisfies_the_circuit_with_its_public_inputs(small):
    config, deployment, table, jtable, (port_setup, _, _) = small
    (req,) = deployment.requests
    proving, _ = provers(config, req, table, jtable)
    setup = port_setup.setup
    pp = setup.pp
    assert len(req.public_inputs) == 8
    assert len(set(req.public_inputs[1:5])) == 4  # four distinct nullifiers
    jcheck_gate(setup, proving, req.public_inputs, jtable, R)
    assert broken_copies(setup, proving) == set()
    # the 4th nullifier altered, then the root: the gate that binds it fails
    for k in (4, 0):
        altered = list(req.public_inputs)
        altered[k] = (altered[k] + 1) % R
        forged = copy.copy(proving)
        forged.pi = {**proving.pi, pp[k]: altered[k]}
        with pytest.raises(AssertionError, match=f"arithmetic gate at {pp[k]} is not"):
            jcheck_gate(setup, forged, altered, jtable, R)
