"""Frozen copies of the port's host modules that the reference needs.

The circuit (constraint system, composer, Poseidon, the Merkle gadget and
the withdraw circuit), the host Merkle tree store and the Merlin
transcript, copied from ``zkt_plonk_tpu_torch`` with no logic changed,
so that the benchmark builds its inputs and the reference derives its
verifier key without importing the system under test.  These files are
part of the yardstick: they change only in a benchmark change.
"""
