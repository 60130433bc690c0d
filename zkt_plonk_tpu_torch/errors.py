"""Error taxonomy — rebuild of ``plonk-core/src/error.rs:15-106``."""

from __future__ import annotations


class PlonkError(Exception):
    """Base class for all proving-system errors."""


class InvalidEvalDomainSize(PlonkError):
    def __init__(self, log_size_of_group: int, adicity: int):
        super().__init__(
            f"domain size 2^{log_size_of_group} exceeds field two-adicity {adicity}"
        )
        self.log_size_of_group = log_size_of_group
        self.adicity = adicity


class ProofVerificationError(PlonkError):
    def __init__(self, step: int):
        super().__init__(f"proof verification failed at step {step}")
        self.step = step


class PCError(PlonkError):
    """Polynomial-commitment-scheme failure."""


class ElementNotIndexedInTable(PlonkError):
    """Lookup query value not present in the table."""


class SynthesisError(PlonkError):
    """Circuit synthesis failed."""


class FullBufferError(SynthesisError):
    """Hasher arity exceeded."""
