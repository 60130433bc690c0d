"""CLI driver: compile / setup-poseidon / init-store / deposit / list-notes /
prove-withdraw.

Rebuild of ``bin/src/main.rs:22-337`` as ``python -m zkt_plonk_tpu_torch.cli``,
with the subcommands, flags, defaults and printed lines of
``python -m zkt_plonk_tpu.cli`` and its files (``utils/serialize.py``):
keys written by either CLI load in the other.  The one addition is the
top-level ``--device`` (default ``cuda``; CUDA asked for but absent
raises), which places the SRS, the keys and the prover.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from dataclasses import dataclass
from typing import List

from . import _cuda
from .circuits.withdraw import WithdrawCircuit
from .commitment import kzg
from .config import DEFAULT_CONFIG, InstanceConfig, transcript_factory
from .cs import LookupTable
from .curves import make_context
from .gadgets.merkle_tree import MerkleTree, MerkleTreeStore
from .gadgets.note import Note, Notes
from .hashing import Poseidon, bn254_constants
from .hashing.merkle import PoECircuit
from .plonk import CompiledCircuit, ZKTPlonk
from .utils import serialize as ser


def identifier_to_int(identifier: str, p: int) -> int:
    """Ethereum address (0x...) -> field element, little-endian bytes
    (``main.rs:323-333``)."""
    h = identifier.lower().removeprefix("0x")
    data = bytes.fromhex(h)
    assert len(data) == 20, "identifier must be a 20-byte address"
    v = int.from_bytes(data, "little")
    assert v < p
    return v


def _build_instance(cfg: InstanceConfig, device, table_elems=()):
    table = LookupTable(table_elems, size=cfg.table_size)
    return ZKTPlonk(
        curve=cfg.curve,
        transcript_factory=transcript_factory(cfg.transcript),
        table=table,
        device=device,
    )


def _default_circuit(cfg: InstanceConfig):
    return WithdrawCircuit.default(
        bn254_constants(cfg.poseidon_width), cfg.note_inputs, cfg.height
    )


def cmd_compile(args, cfg: InstanceConfig):
    ctx = make_context(cfg.curve)
    print(f"generating SRS (2^{args.max_degree.bit_length() - 1})...")
    ck, cvk = kzg.setup(ctx, args.max_degree, device=args.device)
    instance = _build_instance(cfg, args.device)
    print("compiling withdraw circuit...")
    t0 = time.time()
    compiled = instance.compile(_default_circuit(cfg), ck, cvk)
    print(f"compiled: n = {compiled.vk.n} ({time.time() - t0:.1f}s)")

    outs = [args.ck, args.cvk, args.pk, args.vk]
    if not args.no_epk:
        outs.append(args.epk)
    for out in outs:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    ser.save_committer_key(args.ck, compiled.ck)
    ser.save_kzg_vk(args.cvk, compiled.cvk)
    ser.save_prover_key(args.pk, compiled.pk)
    ser.save_verifier_key(args.vk, compiled.vk)
    if not args.no_epk:
        # the reference serializes the EPK alongside pk/vk (``main.rs:108-109``)
        ser.save_extended_prover_key(args.epk, compiled.epk)
    print("keys written")


def cmd_setup_poseidon(args, cfg: InstanceConfig):
    c = bn254_constants(cfg.poseidon_width)
    print(f"full rounds = {c.full_rounds}")
    print(f"partial rounds = {c.partial_rounds}")
    print(f"round constants = {len(c.round_constants)}")
    print(f"mds = {cfg.poseidon_width}x{cfg.poseidon_width}")


def cmd_init_store(args, cfg: InstanceConfig):
    tree = MerkleTreeStore(height=cfg.height)
    ser.save_json(args.merkle_tree, tree.to_dict())
    ser.save_json(args.notes, Notes().to_dict())
    print("stores initialized")


def cmd_deposit(args, cfg: InstanceConfig):
    ctx = make_context(cfg.curve)
    p = ctx.curve.fr.modulus
    rng = random.Random()
    secret = rng.randrange(1, p)
    identifier = identifier_to_int(args.identifier, p)
    amount = int(args.amount)

    hasher = Poseidon(bn254_constants(cfg.poseidon_width), native=True)
    tree = MerkleTree(hasher, MerkleTreeStore.from_dict(ser.load_json(args.merkle_tree)))
    notes = Notes.from_dict(ser.load_json(args.notes))

    commitment = hasher.hash(None, [secret])
    leaf_hash = hasher.hash(None, [identifier, amount, commitment])
    leaf_index = tree.add_leaf(leaf_hash)

    ser.save_json(args.merkle_tree, tree.store.to_dict())
    notes.notes.append(Note(leaf_index, identifier, amount, secret))
    ser.save_json(args.notes, notes.to_dict())
    print(f"deposited at leaf {leaf_index}")


def cmd_list_notes(args, cfg: InstanceConfig):
    notes = Notes.from_dict(ser.load_json(args.notes))
    for i, note in enumerate(notes.notes):
        addr = int(note.identifier).to_bytes(32, "little")[:20]
        print(f"note {i}:")
        print(f"  leaf index = {note.leaf_index}")
        print(f"  identifier = 0x{addr.hex()}")
        print(f"  amount = {note.amount}")


@dataclass
class WithdrawStatement:
    """What ``prove-withdraw`` proves, built from the stores: the circuit,
    the public inputs it is verified against, and the store updates."""

    circuit: WithdrawCircuit
    public_inputs: List[int]
    identifiers_set: List[int]
    tree: MerkleTree
    notes: Notes
    using: List[Note]
    new_leaf: int
    new_identifier: int
    new_secret: int
    amount_out: int


def withdraw_statement(args, cfg: InstanceConfig, rng: random.Random) -> WithdrawStatement:
    """Load the tree and note stores and build the withdraw circuit and its
    public inputs; the new note's secret is the first draw of ``rng``."""
    ctx = make_context(cfg.curve)
    p = ctx.curve.fr.modulus

    assert len(args.note_indexes) == cfg.note_inputs, "unmatched size of input notes"
    assert len(args.identifiers_set) <= cfg.table_size, "identifiers set too large"

    identifiers_set = [identifier_to_int(i, p) for i in args.identifiers_set]
    new_secret = rng.randrange(1, p)
    new_identifier = identifier_to_int(args.identifier, p)
    withdraw_amount = int(args.amount)

    constants = bn254_constants(cfg.poseidon_width)
    hasher = Poseidon(constants, native=True)
    tree = MerkleTree(hasher, MerkleTreeStore.from_dict(ser.load_json(args.merkle_tree)))
    notes = Notes.from_dict(ser.load_json(args.notes))
    using = [notes.notes[i] for i in args.note_indexes]

    circuit = WithdrawCircuit(
        constants=constants,
        height=cfg.height,
        secrets=[n.secret for n in using],
        identifiers=[n.identifier for n in using],
        amount_inputs=[n.amount for n in using],
        poe_circuits=[
            PoECircuit(
                height=cfg.height,
                leaf_index=n.leaf_index,
                path_elements=tree.merkle_path(n.leaf_index),
            )
            for n in using
        ],
        root=tree.root,
        new_secret=new_secret,
        new_identifier=new_identifier,
        withdraw_amount=withdraw_amount,
    )

    amount_out = sum(n.amount for n in using) - withdraw_amount
    nullifiers = [hasher.hash(None, [pow(n.secret, -1, p)]) for n in using]
    new_commitment = hasher.hash(None, [new_secret])
    new_leaf = hasher.hash(None, [new_identifier, amount_out, new_commitment])
    public_inputs = [tree.root] + nullifiers + [withdraw_amount, new_identifier, new_leaf]
    return WithdrawStatement(
        circuit=circuit, public_inputs=public_inputs, identifiers_set=identifiers_set,
        tree=tree, notes=notes, using=using, new_leaf=new_leaf,
        new_identifier=new_identifier, new_secret=new_secret, amount_out=amount_out,
    )


def cmd_prove_withdraw(args, cfg: InstanceConfig):
    rng = random.Random(args.seed)
    st = withdraw_statement(args, cfg, rng)

    instance = _build_instance(cfg, args.device, st.identifiers_set)
    ck = ser.load_committer_key(args.ck, device=args.device)
    cvk = ser.load_kzg_vk(args.cvk)
    pk = ser.load_prover_key(args.pk, device=args.device)
    vk = ser.load_verifier_key(args.vk)

    # EPK: load the serialized file if present (``parser.rs:5-23``), else
    # rebuild from the PK polynomials by FFT, with no circuit re-synthesis
    # (``prove.rs:88-102``)
    epk_path = args.epk if args.epk.endswith(".npz") else args.epk + ".npz"
    if os.path.exists(epk_path):
        epk = ser.load_extended_prover_key(epk_path, device=args.device)
    else:
        from .proof_system.setup import extend_prover_key_from_pk

        epk = extend_prover_key_from_pk(ck, pk)

    compiled = CompiledCircuit(ck=ck, cvk=cvk, pk=pk, epk=epk, vk=vk)

    print("start proving...")
    t0 = time.time()
    proof = instance.prove(compiled, st.circuit, rng)
    print(f"proving finished ({time.time() - t0:.1f}s)")

    print("start verifying...")
    instance.verify(compiled, proof, st.public_inputs)
    print("verifying finished")

    tree, notes = st.tree, st.notes
    new_leaf_index = tree.add_leaf(st.new_leaf)
    ser.save_json(args.merkle_tree, tree.store.to_dict())
    used = {n.leaf_index for n in st.using}
    notes.notes = [n for n in notes.notes if n.leaf_index not in used]
    notes.notes.append(Note(new_leaf_index, st.new_identifier, st.amount_out, st.new_secret))
    ser.save_json(args.notes, notes.to_dict())
    if args.proof_out:
        ser.save_json(args.proof_out, ser.proof_to_dict(proof))
        print(f"proof written to {args.proof_out}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="zkt-plonk-tpu-torch", description="PyTorch/CUDA tools of the ZKT protocol"
    )
    parser.add_argument("--height", type=int, default=DEFAULT_CONFIG.height)
    parser.add_argument("--note-inputs", type=int, default=DEFAULT_CONFIG.note_inputs)
    parser.add_argument("--table-size", type=int, default=DEFAULT_CONFIG.table_size)
    parser.add_argument("--poseidon-width", type=int, default=DEFAULT_CONFIG.poseidon_width)
    parser.add_argument(
        "--transcript", choices=("merlin", "ethereum"),
        default=DEFAULT_CONFIG.transcript,
        help="Fiat-Shamir transcript (reference default: merlin, "
             "bin/Cargo.toml default features; ethereum = EVM-compatible)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the SRS, the keys and the prover (default: cuda)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compile")
    c.add_argument("--max-degree", "-d", type=int, default=1 << 20)
    c.add_argument("--ck", default="data/ck")
    c.add_argument("--cvk", default="data/cvk")
    c.add_argument("--pk", default="data/pk")
    c.add_argument("--vk", default="data/vk")
    c.add_argument("--epk", default="data/epk")
    c.add_argument("--no-epk", action="store_true",
                   help="skip the (large) EPK checkpoint; prove-withdraw "
                        "rebuilds it from the PK by FFT")

    sub.add_parser("setup-poseidon")

    i = sub.add_parser("init-store")
    i.add_argument("--merkle-tree", "-t", default="data/merkle-tree")
    i.add_argument("--notes", "-n", default="data/notes")

    d = sub.add_parser("deposit")
    d.add_argument("--merkle-tree", "-t", default="data/merkle-tree")
    d.add_argument("--notes", "-n", default="data/notes")
    d.add_argument("--identifier", "-i", required=True)
    d.add_argument("--amount", "-a", default="1000")

    l = sub.add_parser("list-notes")
    l.add_argument("--notes", "-n", default="data/notes")

    w = sub.add_parser("prove-withdraw")
    w.add_argument("--ck", default="data/ck")
    w.add_argument("--cvk", default="data/cvk")
    w.add_argument("--pk", default="data/pk")
    w.add_argument("--vk", default="data/vk")
    w.add_argument("--epk", default="data/epk")
    w.add_argument("--merkle-tree", "-t", default="data/merkle-tree")
    w.add_argument("--notes", "-n", default="data/notes")
    w.add_argument("--note-indexes", "-x", type=int, action="append", required=True)
    w.add_argument("--identifiers-set", "-s", action="append", default=[])
    w.add_argument("--identifier", "-i", required=True)
    w.add_argument("--amount", "-a", required=True)
    w.add_argument("--seed", type=int, default=None)
    w.add_argument("--proof-out", default=None)
    return parser


def config_from_args(args) -> InstanceConfig:
    return InstanceConfig(
        transcript=args.transcript,
        height=args.height,
        note_inputs=args.note_inputs,
        table_size=args.table_size,
        poseidon_width=args.poseidon_width,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    _cuda.require_cuda(args.device)
    {
        "compile": cmd_compile,
        "setup-poseidon": cmd_setup_poseidon,
        "init-store": cmd_init_store,
        "deposit": cmd_deposit,
        "list-notes": cmd_list_notes,
        "prove-withdraw": cmd_prove_withdraw,
    }[args.cmd](args, config_from_args(args))


if __name__ == "__main__":
    main()
