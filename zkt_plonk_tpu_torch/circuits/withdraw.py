"""The withdraw circuit — the protocol's end-to-end driver.

Rebuild of ``circuits/src/withdraw.rs:13-151``.  Per input note:
commitment = H(secret); nullifier = H(1/secret) (public);
leaf = H(identifier, amount, commitment); Merkle PoE against the public
root; identifier membership in the lookup table.  Balance: amount_out is
bit-decomposed (range proof) and in_0 + Σin - out = withdraw_amount is
enforced with the withdraw amount as a public input.  New note:
new_leaf = H(new_id, amount_out, H(new_secret)) with new_id and new_leaf
public.

Public input order (``bin/src/main.rs:266-271``):
  [root, nullifier_1..k, withdraw_amount, new_identifier, new_leaf]
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..cs.system import ConstraintSystem
from ..cs.variable import LTVariable, ZERO, lt
from ..hashing.merkle import PoECircuit
from ..hashing.poseidon.constants import PoseidonConstants
from ..hashing.poseidon.spec import Poseidon
from ..utils.profiling import section

AMOUNT_BITS = 64  # A = u64 in the reference


@dataclass
class WithdrawCircuit:
    constants: PoseidonConstants
    height: int
    secrets: List[int] = field(default_factory=list)
    identifiers: List[int] = field(default_factory=list)
    amount_inputs: List[int] = field(default_factory=list)
    poe_circuits: List[PoECircuit] = field(default_factory=list)
    root: int = 0
    new_secret: int = 0
    new_identifier: int = 0
    withdraw_amount: int = 0

    @staticmethod
    def default(constants: PoseidonConstants, inputs: int, height: int):
        return WithdrawCircuit(
            constants=constants,
            height=height,
            secrets=[0] * inputs,
            identifiers=[0] * inputs,
            amount_inputs=[0] * inputs,
            poe_circuits=[PoECircuit(height=height) for _ in range(inputs)],
        )

    def synthesize(self, cs: ConstraintSystem) -> None:
        hasher = Poseidon(self.constants, native=False)

        amount_in = sum(self.amount_inputs)
        assert amount_in >= self.withdraw_amount, "invalid withdraw amount"
        amount_out = amount_in - self.withdraw_amount

        # -- step 1: existence proofs of inputs ----------------------------
        amount_in_vars = [cs.assign_variable(a) for a in self.amount_inputs]
        identifier_vars = [cs.assign_variable(i) for i in self.identifiers]

        one_var = LTVariable.constant(1)
        pub_root_var = lt(cs.assign_variable(self.root))
        cs.set_variable_public(pub_root_var)

        for amount_var, identifier_var, secret, poe in zip(
            amount_in_vars, identifier_vars, self.secrets, self.poe_circuits
        ):
            with section("note"):
                secret_var = lt(cs.assign_variable(secret))
                commitment_var = hasher.hash(cs, [secret_var])

                secret_inv_var = cs.div_gate(one_var, secret_var)
                nullifier_var = hasher.hash(cs, [lt(secret_inv_var)])
                cs.set_variable_public(nullifier_var)

                leaf_var = hasher.hash(
                    cs, [lt(identifier_var), lt(amount_var), commitment_var]
                )

                root_var, _ = poe.synthesize(cs, hasher, leaf_var)
                cs.equal_constrain(root_var, pub_root_var)

                cs.lookup_constrain(lt(identifier_var))

        # -- step 2: balance proof -----------------------------------------
        with section("balance"):
            amount_out_bits = []
            for i in range(AMOUNT_BITS):
                bit = (amount_out >> i) & 1
                var = cs.assign_variable(bit)
                amount_out_bits.append(cs.boolean_gate(var))
            amount_out_var = cs.bits_le_constrain(amount_out_bits)

            left_var = amount_in_vars[0]
            right_var = ZERO
            for amount_var in amount_in_vars[1:]:
                right_var = cs.add_gate(lt(right_var), lt(amount_var))
            sels = cs.sels().with_left(-1).with_right(-1).with_out(1)
            cs.arith_constrain(
                left_var, right_var, amount_out_var, sels, pi=self.withdraw_amount
            )

        # -- step 3: new note commitment -----------------------------------
        with section("new_note"):
            new_secret_var = lt(cs.assign_variable(self.new_secret))
            new_identifier_var = lt(cs.assign_variable(self.new_identifier))
            new_commitment_var = hasher.hash(cs, [new_secret_var])
            new_leaf_var = hasher.hash(
                cs, [new_identifier_var, lt(amount_out_var), new_commitment_var]
            )
            cs.set_variable_public(new_identifier_var)
            cs.set_variable_public(new_leaf_var)
