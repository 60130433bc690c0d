"""The port's CLI and key files on the CPU against the JAX package.

Every check is exact (equal printed lines, equal ints, equal limbs):
(a) ``identifier_to_int``, ``setup-poseidon``, ``init-store``,
    ``deposit`` and ``list-notes`` print what the JAX CLI prints on the
    same argv, and the JSON stores each writes load in the other;
(b) the withdraw statement that ``prove-withdraw`` builds from the stores
    (``--height 4 --note-inputs 1``): the circuit, synthesized in proving
    mode, makes public exactly the inputs the CLI verifies against; those
    equal the JAX hasher's from the same stores, and the JAX circuit on
    the same notes gives the same wires;
(c) keys of the golden TinyCircuit (n = 64) cross between the packages'
    files in both directions: JAX-written keys load in the port limb for
    limb and prove the golden digest; port-written keys load in the JAX
    package as equal arrays; a port-written proof verifies under the JAX
    verifier with the JAX-loaded keys;
(d) ``--device cuda`` raises where there is no card.
No withdraw circuit is proved here: at its smallest (n = 2^14) that takes
minutes on the CPU; ``chip_smoke.py`` runs the whole CLI flow on the card.
"""

import contextlib
import hashlib
import io
import os
import random

import numpy as np
import pytest
import torch

from zkt_plonk_tpu import cli as jcli
from zkt_plonk_tpu.circuits.withdraw import WithdrawCircuit as JWithdrawCircuit
from zkt_plonk_tpu.commitment import kzg as jkzg
from zkt_plonk_tpu.cs import ConstraintSystem as JConstraintSystem
from zkt_plonk_tpu.cs import LookupTable as JLookupTable
from zkt_plonk_tpu.cs import lt as jlt
from zkt_plonk_tpu.gadgets.merkle_tree import MerkleTree as JMerkleTree
from zkt_plonk_tpu.gadgets.merkle_tree import MerkleTreeStore as JMerkleTreeStore
from zkt_plonk_tpu.gadgets.note import Notes as JNotes
from zkt_plonk_tpu.hashing import Poseidon as JPoseidon
from zkt_plonk_tpu.hashing import bn254_constants as jbn254_constants
from zkt_plonk_tpu.hashing.merkle import PoECircuit as JPoECircuit
from zkt_plonk_tpu.plonk import CompiledCircuit as JCompiledCircuit
from zkt_plonk_tpu.plonk import ZKTPlonk as JZKTPlonk
from zkt_plonk_tpu.proof_system.proof import VerificationError as JVerificationError
from zkt_plonk_tpu.utils import serialize as jser
from zkt_plonk_tpu_torch import cli
from zkt_plonk_tpu_torch.cs import ConstraintSystem, LookupTable, lt
from zkt_plonk_tpu_torch.fields import BN254_FR
from zkt_plonk_tpu_torch.plonk import CompiledCircuit, ZKTPlonk
from zkt_plonk_tpu_torch.proof_system.keys import POLY_ORDER
from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
from zkt_plonk_tpu_torch.utils import arkserde
from zkt_plonk_tpu_torch.utils import serialize as ser


@pytest.fixture(scope="module", autouse=True)
def _share_cores_with_xdist_workers():
    """The plain versions run many small torch ops; under pytest-xdist every
    worker's intra-op threads would contend for all cores, so each worker
    takes its share of them while this module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


P = BN254_FR.modulus
GOLDEN = "504e1dbfaa28af3d1e9da112bbb4329374e06669416c39ec1fc8015df71d3cba"
EPK_TABLES = ("x_coset", "zh_coset_inv", "l1_coset", "sigma_evals", "roots")


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def _port(argv):
    return _lines(cli.main, ["--device", "cpu"] + argv)


def _jax(argv):
    return _lines(jcli.main, argv)


def _addr(i):
    return "0x" + bytes(random.Random(i).randrange(256) for _ in range(20)).hex()


def test_identifier_to_int_matches_jax():
    for i in range(20):
        a = _addr(i)
        assert cli.identifier_to_int(a, P) == jcli.identifier_to_int(a, P)
        assert cli.identifier_to_int(a.upper().replace("0X", "0x"), P) == cli.identifier_to_int(a, P)
    for bad in ("0x1234", "0x" + "ab" * 21):
        with pytest.raises(AssertionError):
            cli.identifier_to_int(bad, P)
        with pytest.raises(AssertionError):
            jcli.identifier_to_int(bad, P)


@pytest.mark.parametrize("width", [3, 4])
def test_setup_poseidon_prints_as_jax(width):
    argv = ["--poseidon-width", str(width), "setup-poseidon"]
    assert _port(argv) == _jax(argv)


def test_store_flow_prints_as_jax_and_files_cross(tmp_path):
    base = ["--height", "8", "--note-inputs", "1", "--table-size", "8", "--poseidon-width", "4"]
    paths = {}
    for who, run in (("port", _port), ("jax", _jax)):
        tree, notes = str(tmp_path / f"{who}-tree"), str(tmp_path / f"{who}-notes")
        paths[who] = (tree, notes)
        printed = run(base + ["init-store", "-t", tree, "-n", notes])
        for i, amount in enumerate(("500", "300", "1000")):
            printed += run(base + ["deposit", "-t", tree, "-n", notes, "-i", _addr(i), "-a", amount])
        paths[who + "-printed"] = printed
    assert paths["port-printed"] == paths["jax-printed"] == [
        "stores initialized", "deposited at leaf 0", "deposited at leaf 1", "deposited at leaf 2"]

    # each CLI lists the other's notes as that one does
    for who in ("port", "jax"):
        notes = paths[who][1]
        listed = _port(["list-notes", "-n", notes])
        assert listed == _jax(["list-notes", "-n", notes])
        assert "  amount = 300" in listed and len(listed) == 12

    # the port's tree store loads in the JAX package with the same root
    tree_json = ser.load_json(paths["port"][0])
    store = JMerkleTreeStore.from_dict(tree_json)
    assert store.to_dict() == tree_json
    from zkt_plonk_tpu_torch.gadgets.merkle_tree import MerkleTree, MerkleTreeStore
    from zkt_plonk_tpu_torch.hashing import Poseidon, bn254_constants

    jroot = JMerkleTree(JPoseidon(jbn254_constants(4), native=True), store).root
    proot = MerkleTree(Poseidon(bn254_constants(4), native=True),
                       MerkleTreeStore.from_dict(tree_json)).root
    assert jroot == proot != 0


def test_withdraw_statement_public_inputs(tmp_path):
    base = ["--height", "4", "--note-inputs", "1", "--table-size", "8", "--poseidon-width", "4"]
    tree, notes = str(tmp_path / "tree"), str(tmp_path / "notes")
    _port(base + ["init-store", "-t", tree, "-n", notes])
    for i, amount in enumerate(("500", "300")):
        _port(base + ["deposit", "-t", tree, "-n", notes, "-i", _addr(i), "-a", amount])
    argv = base + ["prove-withdraw", "-t", tree, "-n", notes, "-x", "1", "-s", _addr(0),
                   "-s", _addr(1), "-i", _addr(5), "-a", "120", "--seed", "42"]
    args = cli.build_parser().parse_args(["--device", "cpu"] + argv)
    cfg = cli.config_from_args(args)
    st = cli.withdraw_statement(args, cfg, random.Random(42))

    # the circuit in proving mode makes public what the CLI verifies against
    cs = ConstraintSystem(P, setup=False, lookup_table=LookupTable(st.identifiers_set, size=8))
    st.circuit.synthesize(cs)
    assert cs.proving.pi_values() == [v % P for v in st.public_inputs]
    assert len(st.public_inputs) == 5 and st.amount_out == 300 - 120

    # the same values from the JAX hasher and the JAX stores
    hasher = JPoseidon(jbn254_constants(4), native=True)
    jtree = JMerkleTree(hasher, JMerkleTreeStore.from_dict(jser.load_json(tree)))
    note = JNotes.from_dict(jser.load_json(notes)).notes[1]
    new_secret = random.Random(42).randrange(1, P)
    new_id = jcli.identifier_to_int(_addr(5), P)
    new_leaf = hasher.hash(None, [new_id, note.amount - 120, hasher.hash(None, [new_secret])])
    nullifier = hasher.hash(None, [pow(note.secret, -1, P)])
    assert st.public_inputs == [jtree.root, nullifier, 120, new_id, new_leaf]

    # the JAX circuit on the same notes: the same public values and wires
    jcircuit = JWithdrawCircuit(
        constants=jbn254_constants(4), height=4, secrets=[note.secret],
        identifiers=[note.identifier], amount_inputs=[note.amount],
        poe_circuits=[JPoECircuit(height=4, leaf_index=note.leaf_index,
                                  path_elements=jtree.merkle_path(note.leaf_index))],
        root=jtree.root, new_secret=new_secret, new_identifier=new_id, withdraw_amount=120,
    )
    jcs = JConstraintSystem(P, setup=False, lookup_table=JLookupTable(st.identifiers_set, size=8))
    jcircuit.synthesize(jcs)
    assert jcs.proving.pi_values() == cs.proving.pi_values()
    assert jcs.proving.wire_evals() == cs.proving.wire_evals()


class TinyCircuit:
    """The golden circuit of ``tests/test_e2e.py``, for either package."""

    def __init__(self, lt_fn):
        self.lt = lt_fn

    def synthesize(self, cs):
        a = cs.assign_variable(2)
        b = cs.assign_variable(3)
        c = cs.mul_gate(self.lt(a), self.lt(b))
        d = cs.add_gate(self.lt(c), self.lt(a))
        cs.set_variable_public(self.lt(d))
        cs.lookup_constrain(self.lt(a))


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The golden TinyCircuit compiled by the JAX package, and its key files."""
    d = tmp_path_factory.mktemp("jax-keys")
    jinst = JZKTPlonk(curve="bn254", table=JLookupTable([1, 2, 5], size=63))
    jck, jcvk = jkzg.setup(jinst.ctx, max_degree=4 * 64, tau=123456789)
    jc = jinst.compile(TinyCircuit(jlt), jck, jcvk)
    files = {k: str(d / k) for k in ("ck", "cvk", "pk", "vk", "epk")}
    jser.save_committer_key(files["ck"], jc.ck)
    jser.save_kzg_vk(files["cvk"], jc.cvk)
    jser.save_prover_key(files["pk"], jc.pk)
    jser.save_verifier_key(files["vk"], jc.vk)
    jser.save_extended_prover_key(files["epk"], jc.epk)
    return jinst, jc, files


def _load_port(files):
    return CompiledCircuit(
        ck=ser.load_committer_key(files["ck"], device="cpu"),
        cvk=ser.load_kzg_vk(files["cvk"]),
        pk=ser.load_prover_key(files["pk"], device="cpu"),
        epk=ser.load_extended_prover_key(files["epk"], device="cpu"),
        vk=ser.load_verifier_key(files["vk"]),
    )


def _eq(got: torch.Tensor, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


def test_jax_key_files_load_and_prove_golden(jax_keys, tmp_path):
    jinst, jc, files = jax_keys
    c = _load_port(files)
    _eq(c.ck.powers, jc.ck.powers)
    assert c.ck.ctx.name == "bn254" and c.ck.b3.value == 9
    for name in POLY_ORDER:
        _eq(c.pk.polys[name], jc.pk.polys[name])
        _eq(c.epk.coset[name], jc.epk.coset[name])
    for name in EPK_TABLES:
        _eq(getattr(c.epk, name), getattr(jc.epk, name))
    assert c.epk.q_lookup_evals_host == [int(v) for v in jc.epk.q_lookup_evals_host]
    assert (c.vk.n, c.vk.pi_pos, c.vk.domain_gen, c.vk.commitments) == (
        jc.vk.n, jc.vk.pi_pos, jc.vk.domain_gen, jc.vk.commitments)
    assert [(x.a, x.b) for x in c.cvk.tau_g2] == [(x.a, x.b) for x in jc.cvk.tau_g2]

    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device="cpu")
    proof = inst.prove(c, TinyCircuit(lt), rng=random.Random(9))
    blob = arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)
    assert (len(blob), hashlib.sha256(blob).hexdigest()) == (802, GOLDEN)

    # the port's proof file verifies under the JAX verifier with JAX-loaded keys
    proof_path = str(tmp_path / "proof.json")
    ser.save_json(proof_path, ser.proof_to_dict(proof))
    jproof = jser.proof_from_dict(jser.load_json(proof_path))
    jcompiled = JCompiledCircuit(
        ck=None, cvk=jser.load_kzg_vk(files["cvk"]), pk=None, epk=None,
        vk=jser.load_verifier_key(files["vk"]),
    )
    jinst.verify(jcompiled, jproof, [8])
    with pytest.raises((JVerificationError, AssertionError)):
        jinst.verify(jcompiled, jproof, [9])
    assert ser.proof_from_dict(ser.load_json(proof_path)) == proof
    inst.verify(c, ser.proof_from_dict(ser.load_json(proof_path)), [8])
    with pytest.raises((VerificationError, AssertionError)):
        inst.verify(c, proof, [9])


def test_port_key_files_load_in_jax(jax_keys, tmp_path):
    _, jc, files = jax_keys
    c = _load_port(files)
    out = {k: str(tmp_path / k) for k in ("ck", "cvk", "pk", "vk", "epk")}
    ser.save_committer_key(out["ck"], c.ck)
    ser.save_kzg_vk(out["cvk"], c.cvk)
    ser.save_prover_key(out["pk"], c.pk)
    ser.save_verifier_key(out["vk"], c.vk)
    ser.save_extended_prover_key(out["epk"], c.epk)

    # the same npz keys and dtypes as the JAX package's files
    for k in ("ck", "pk", "epk"):
        mine, ref = np.load(out[k] + ".npz", allow_pickle=True), np.load(files[k] + ".npz", allow_pickle=True)
        assert sorted(mine.files) == sorted(ref.files)
        for name in ref.files:
            assert mine[name].dtype == ref[name].dtype, (k, name)
            np.testing.assert_array_equal(mine[name], ref[name])
    for k in ("cvk", "vk"):
        assert ser.load_json(out[k]) == ser.load_json(files[k])

    ck = jser.load_committer_key(out["ck"])
    np.testing.assert_array_equal(np.asarray(ck.powers), np.asarray(jc.ck.powers))
    assert ck.ctx.name == "bn254"
    pk = jser.load_prover_key(out["pk"])
    epk = jser.load_extended_prover_key(out["epk"])
    for name in POLY_ORDER:
        np.testing.assert_array_equal(np.asarray(pk.polys[name]), np.asarray(jc.pk.polys[name]))
        np.testing.assert_array_equal(np.asarray(epk.coset[name]), np.asarray(jc.epk.coset[name]))
    for name in EPK_TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(epk, name)), np.asarray(getattr(jc.epk, name)))
    assert epk.q_lookup_evals_host == [int(v) for v in jc.epk.q_lookup_evals_host]
    vk = jser.load_verifier_key(out["vk"])
    assert (vk.n, vk.pi_pos, vk.domain_gen, vk.commitments) == (
        jc.vk.n, jc.vk.pi_pos, jc.vk.domain_gen, jc.vk.commitments)


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["init-store", "-t", str(tmp_path / "t"), "-n", str(tmp_path / "n")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--device", "cuda", "compile", "-d", "256", "--ck", str(tmp_path / "ck")])
    assert not os.path.exists(tmp_path / "t") and not os.path.exists(tmp_path / "ck.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        ser.load_prover_key(str(tmp_path / "missing"))
