"""The ``serial`` path: one client in a closed loop.  Each request is one
``ZKTPlonk.prove`` of the next withdraw of the pool, its answer the proof's
bytes once the card is synchronized; the client sends the next request
when it has the answer.

A path is found by the name a traffic mix gives under ``path``.  It
gives ``check(traffic)``, which raises on a mix it cannot serve;
``warm_up(setup, spans)``, the answers of the proofs before the window;
and ``window(setup, seconds, spans)``, a ``core.window.Window`` whose
record k answers the pool's request k % pool.  With ``spans`` (a list, in
the traced run) each proof appends the benchmark's host spans to it.
"""

from __future__ import annotations

from benchmark.core import inputs
from benchmark.core import window as win


def check(traffic: dict) -> None:
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError(f"traffic {traffic['name']}: the serial path serves one client "
                         "in a closed loop")


def serve(setup, k: int, spans=None) -> bytes:
    """The window's k-th request: the pool's request k % pool, with the
    k-th request's own blinders."""
    return setup.port.prove(setup.circuit(k), inputs.proof_rng(setup.seed, k), spans)


def warm_up(setup, spans=None):
    """The traffic's ``warmup`` proofs of the pool's first requests, each
    with blinders of its own (negative k), so the window proves each of
    them again."""
    return [setup.port.prove(setup.circuit(i), inputs.proof_rng(setup.seed, -1 - i), spans)
            for i in range(setup.traffic["warmup"])]


def window(setup, seconds: float, spans=None) -> win.Window:
    return win.closed_loop(lambda k: serve(setup, k, spans), seconds)
