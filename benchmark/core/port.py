"""The system under test: ``zkt_plonk_tpu_torch``, driven through its
public API, as the reference ``bin`` and the port's CLI drive it.

This is the one module of the benchmark that imports the port, and it
imports it inside ``Port``: the rest of the harness and the reference
never see it.  ``Port`` takes the configuration and the finished inputs
of a deployment (``inputs.Deployment``); it sets up the SRS from the
deployment's tau, compiles the withdraw circuit, and proves requests.
"""

from __future__ import annotations

import time
from typing import List, Optional


class Port:
    def __init__(self, config: dict, deployment, device: str, say=lambda *a: None):
        import torch

        from zkt_plonk_tpu_torch import _cuda
        from zkt_plonk_tpu_torch.circuits.withdraw import WithdrawCircuit
        from zkt_plonk_tpu_torch.commitment import kzg
        from zkt_plonk_tpu_torch.cs import LookupTable
        from zkt_plonk_tpu_torch.hashing import PoseidonConstants, bn254_constants
        from zkt_plonk_tpu_torch.hashing.merkle import PoECircuit
        from zkt_plonk_tpu_torch.plonk import ZKTPlonk
        from zkt_plonk_tpu_torch.transcript import EthereumTranscript, MerlinTranscript
        from zkt_plonk_tpu_torch.utils import arkserde

        self.torch = torch
        self._cuda = _cuda
        self._arkserde = arkserde
        self._WithdrawCircuit = WithdrawCircuit
        self._PoECircuit = PoECircuit
        self.config = config
        self.device = torch.device(device)

        if config["transcript"] == "merlin":
            coord = config["coord_bytes"]
            factory = lambda label: MerlinTranscript(label, coord_bytes=coord)  # noqa: E731
        elif config["transcript"] == "ethereum":
            factory = EthereumTranscript
        else:
            raise ValueError(f"unknown transcript {config['transcript']!r}")
        self.inst = ZKTPlonk(curve=config["curve"], transcript_factory=factory,
                             table=LookupTable(deployment.table, size=config["table_size"]),
                             device=self.device)
        ctx = self.inst.ctx
        if config["curve"] == "bn254":
            self.constants = bn254_constants(config["poseidon_width"])
        else:
            r = ctx.curve.fr.modulus
            self.constants = PoseidonConstants.generate(r, config["poseidon_width"], r.bit_length())
        self.q, self.r = ctx.curve.fq.modulus, ctx.curve.fr.modulus

        t0 = time.perf_counter()
        ck, cvk = kzg.setup(ctx, max_degree=config["srs_degree"], tau=deployment.tau,
                            device=self.device)
        self.sync()
        say(f"srs {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        self.compiled = self.inst.compile(self.circuit(deployment.requests[0]), ck, cvk)
        self.sync()
        say(f"compile {time.perf_counter() - t0:.3f} s, n = {self.compiled.vk.n}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def circuit(self, req):
        """The port's withdraw circuit of request ``req`` (its witness)."""
        height = self.config["height"]
        return self._WithdrawCircuit(
            constants=self.constants,
            height=height,
            secrets=list(req.secrets),
            identifiers=list(req.identifiers),
            amount_inputs=list(req.amounts),
            poe_circuits=[self._PoECircuit(height=height, leaf_index=i, path_elements=list(p))
                          for i, p in zip(req.leaf_indices, req.paths)],
            root=req.root,
            new_secret=req.new_secret,
            new_identifier=req.new_identifier,
            withdraw_amount=req.withdraw_amount,
        )

    def answer(self, proof) -> bytes:
        """The proof as its users receive it: arkworks bytes."""
        return self._arkserde.proof_to_bytes(proof, self.q, self.r)

    def prove(self, circuit, rng, spans: Optional[List] = None) -> bytes:
        """One request: ``ZKTPlonk.prove``, then the card synchronized.  With
        ``spans``, the same calls split as ``ZKTPlonk.prove`` makes them,
        ``statement`` then ``Prover.prove``, each span appended as
        (name, start, end) on the host's ``perf_counter``."""
        if spans is None:
            proof = self.inst.prove(self.compiled, circuit, rng)
            self.sync()
            return self.answer(proof)
        t0 = time.perf_counter()
        composer, transcript = self.inst.statement(self.compiled, circuit)
        t1 = time.perf_counter()
        proof = self.inst.prover(self.compiled).prove(composer, transcript, rng)
        self.sync()
        t2 = time.perf_counter()
        spans.append(("statement", t0, t1))
        spans.append(("prove", t1, t2))
        return self.answer(proof)

    def launches(self) -> int:
        """Kernel launches so far, every instance (``_cuda.launches``)."""
        return sum(self._cuda.launches.values())

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        """Free the keys and the prover's state on the card."""
        self.compiled = None
        self.inst = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
