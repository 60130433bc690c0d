"""Instance configuration.

Rebuild of the reference's compile-time feature config
(``bin/src/instance.rs:7-90``), as in ``zkt_plonk_tpu/config.py``: curve,
transcript, tree height, note count, lookup-table size, Poseidon width and
SRS degree, as a runtime dataclass.

Defaults match the reference CLI defaults: BN254, MERLIN transcript
(``bin/Cargo.toml`` default features include ``merlin-transcript``),
height-48, 3 notes, TABLE_SIZE=1024, Poseidon x4, KZG10, SRS 2^20.

The JAX package's ``msm_window`` and ``mesh_shape`` are left out: they are
TPU knobs with no reference analog, and nothing in this package reads
them (the MSM picks its own window, ``ops/msm.msm_window_size``).  A mesh
shape comes back with the sharded prover.
"""

from __future__ import annotations

from dataclasses import dataclass


def transcript_factory(name: str):
    """Resolve a transcript name to its factory (``instance.rs:17-20``)."""
    from .transcript import EthereumTranscript, MerlinTranscript

    try:
        return {"ethereum": EthereumTranscript, "merlin": MerlinTranscript}[name]
    except KeyError:
        raise ValueError(f"unknown transcript {name!r} (ethereum|merlin)") from None


@dataclass(frozen=True)
class InstanceConfig:
    curve: str = "bn254"
    transcript: str = "merlin"  # "merlin" (reference default) | "ethereum"
    height: int = 48
    note_inputs: int = 3
    table_size: int = 1024
    poseidon_width: int = 4
    max_degree: int = 1 << 20


DEFAULT_CONFIG = InstanceConfig()


def small_test_config() -> InstanceConfig:
    """A shrunken instance for tests."""
    return InstanceConfig(
        height=8, note_inputs=1, table_size=64, poseidon_width=3, max_degree=1 << 14
    )
