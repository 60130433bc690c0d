"""Top-level ZKTPlonk API: compile / prove / verify on a torch device.

Rebuild of ``plonk-core/src/plonk.rs:32-125``, the counterpart of
``zkt_plonk_tpu/plonk.py``: a circuit is any object with
``synthesize(cs)`` (run once in setup mode, once in proving mode); the
instance bundles the curve context, the transcript factory, the lookup
table and the device (default ``"cuda"``; CUDA asked for but absent
raises).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol

from . import _cuda
from .commitment import scheme as scheme_mod
from .cs import ConstraintSystem, LookupTable
from .curves import make_context
from .proof_system import setup as setup_mod
from .proof_system.keys import ExtendedProverKey, ProverKey, VerifierKey
from .proof_system.proof import Proof
from .proof_system.prover import Prover
from .transcript import EthereumTranscript
from .utils.profiling import begin_request, count, section

TRANSCRIPT_LABEL = "ZKT Plonk"


class Circuit(Protocol):
    def synthesize(self, cs: ConstraintSystem) -> None: ...


@dataclass(eq=False)
class CompiledCircuit:
    ck: object
    cvk: object
    pk: ProverKey
    epk: Optional[ExtendedProverKey]
    vk: VerifierKey
    _prover: Optional[Prover] = None  # built on the first prove


class ZKTPlonk:
    """PLONK+Plookup instance over a named curve (default BN254 + Ethereum
    transcript).  The committer key passed to ``compile`` must live on
    this instance's device."""

    def __init__(
        self,
        curve: str = "bn254",
        transcript_factory: Callable = EthereumTranscript,
        table: Optional[LookupTable] = None,
        device="cuda",
    ):
        self.device = _cuda.require_cuda(device)
        self.ctx = make_context(curve)
        self.p = self.ctx.curve.fr.modulus
        self.transcript_factory = transcript_factory
        self.table = table if table is not None else LookupTable()

    def compile(self, circuit: Circuit, ck, cvk, extend: bool = True) -> CompiledCircuit:
        if ck.device.type != self.device.type:
            raise ValueError(f"committer key on {ck.device}, instance on {self.device}")
        cs = ConstraintSystem(self.p, setup=True, lookup_table=self.table)
        circuit.synthesize(cs)

        bound = cs.circuit_bound()
        ck_t, cvk_t = scheme_mod.for_key(ck).trim(ck, cvk, bound * 4)
        pk, epk, vk = setup_mod.setup(ck_t, cs.setup, self.table, bound, extend=extend)
        return CompiledCircuit(ck=ck_t, cvk=cvk_t, pk=pk, epk=epk, vk=vk)

    def statement(self, compiled: CompiledCircuit, circuit: Circuit):
        """What a prover's ``prove`` takes besides the rng: the proving
        composer of ``circuit``'s witness and the transcript seeded with
        ``compiled``'s verifier key (a ``parallel.BatchProver`` takes one
        of each per proof).  It begins a new request of the span recorder
        (``utils/profiling``) on this thread, which the prover's ``prove``
        that follows on it continues, and adds the circuit's gates and
        domain rows to the counters ``circuit_gates`` and ``domain_rows``."""
        begin_request()
        with section("statement"):
            cs = ConstraintSystem(self.p, setup=False, lookup_table=self.table)
            with section("synthesize"):
                circuit.synthesize(cs)
            count(circuit_gates=cs.n, domain_rows=cs.circuit_bound())
            transcript = self.transcript_factory(TRANSCRIPT_LABEL)
            with section("seed_transcript"):
                compiled.vk.seed_transcript(transcript)
            return cs.proving, transcript

    def prover(self, compiled: CompiledCircuit) -> Prover:
        """``compiled``'s single-device prover, built on first use."""
        if compiled._prover is None:
            compiled._prover = Prover(
                compiled.ck, compiled.pk, compiled.epk, compiled.vk, self.table
            )
        return compiled._prover

    def prove(
        self,
        compiled: CompiledCircuit,
        circuit: Circuit,
        rng: Optional[random.Random] = None,
        prover=None,
    ) -> Proof:
        """Produce a proof.  All proof randomness (the ZK blinders) flows
        through ``rng``: with ``random.Random(seed)`` the proof bytes are a
        pure function of (keys, witness, seed).  ``prover`` may be a
        ``parallel.ShardedProver`` of ``compiled``'s circuit; the proof
        bytes are the same."""
        rng = rng if rng is not None else random.Random()
        composer, transcript = self.statement(compiled, circuit)
        return (prover or self.prover(compiled)).prove(composer, transcript, rng)

    def verify(self, compiled: CompiledCircuit, proof: Proof, pub_inputs: List[int]) -> None:
        """Raises ``VerificationError`` (or AssertionError) on failure."""
        transcript = self.transcript_factory(TRANSCRIPT_LABEL)
        compiled.vk.seed_transcript(transcript)
        proof.verify(compiled.cvk, compiled.vk, transcript, pub_inputs, self.p)
