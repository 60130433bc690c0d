"""The port's spans and counters, kept in memory.

``section(name)`` times one span of the program at a layer boundary.  Off
(the default), it checks one flag and returns a shared no-op context: no
clock read, no sync, nothing on the card.  On (``enable``), each span
closed appends one ``Span`` to an in-memory list, which the reader that
turned recording on takes with ``drain``: name, start and end on
``time.perf_counter()``, its own index and its parent's (the span open on
the same thread when it began; -1 for a root), its request id and its
thread.  Indices number the spans of the process, so a parent drained
later is still found by its index.

A request is one proof: ``begin_request`` (``ZKTPlonk.statement``) gives
the calling thread a new id, which its root spans take, the prover's
``prove`` after the statement included.  A root span on a thread that
has none (a ``parallel.BatchProver`` row) takes a fresh id of its own,
so the rows' proofs never share one.

``counters`` are plain integers that count always, whether recording is on
or not, and never read the card: ``h2d_copies`` and ``h2d_bytes``, the
host limbs handed to the prover's device (``fields.device.upload``: a
copy on the card, of 2 bytes a limb), and ``h2d_pinned_bytes``, those of
the bytes copied from pinned memory (all of them on a card, none on the
CPU);
``host_waits``, the blocking reads of the device on the prove path (one
per ``wait`` span, through ``waiting``); ``circuit_gates`` and
``domain_rows``, the proving composer's gates and its ``circuit_bound()``,
added once per ``ZKTPlonk.statement``, so gates and rows a proof.  Kernel
work is counted beside the launches, in ``_cuda.work``.

The rest of the module reads spans and a device trace on one clock:
interval unions, each span's path and self time, the device intervals of
a ``torch.profiler`` Chrome trace, and idle gaps named by the innermost
span open at their middle.  It imports no torch, so it cannot touch the
card.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Sequence, Tuple


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter() seconds
    end: float
    index: int  # this span's number in the process
    parent: int  # the enclosing span's index on the same thread, or -1
    request: int
    thread: int  # threading.get_ident()


counters: Dict[str, int] = {"h2d_copies": 0, "h2d_bytes": 0, "h2d_pinned_bytes": 0,
                            "host_waits": 0, "circuit_gates": 0, "domain_rows": 0}

_on = False
_lock = threading.Lock()
_records: List[Span] = []
_local = threading.local()  # .stack: the open spans (_Open); .request
_indices = itertools.count()
_requests = itertools.count(1)
_OFF = nullcontext()


def enable(on: bool = True) -> None:
    """Turn span recording on or off (counters count either way)."""
    global _on
    _on = on


def enabled() -> bool:
    return _on


def drain() -> List[Span]:
    """The spans closed since the last drain, in the order they closed."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


def begin_request() -> None:
    """Give this thread a new request id for the root spans that follow."""
    if _on:
        _local.request = next(_requests)


def section(name: str):
    """A context that records one span named ``name`` while recording is on."""
    return _Open(name) if _on else _OFF


class _Open:
    """One span while it is open: pushed on its thread's stack on entry,
    recorded on exit."""

    __slots__ = ("name", "index", "parent", "request", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent, self.request = stack[-1].index, stack[-1].request
        else:
            self.parent = -1
            self.request = getattr(_local, "request", None) or next(_requests)
        self.index = next(_indices)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        span = Span(self.name, self.start, end, self.index, self.parent, self.request,
                    threading.get_ident())
        with _lock:
            _records.append(span)
        return False


def count(**deltas: int) -> None:
    """Add to counters by name, e.g. ``count(h2d_copies=1, h2d_bytes=n)``."""
    with _lock:
        for name, k in deltas.items():
            counters[name] += k


def snapshot() -> Dict[str, int]:
    """A copy of the counters."""
    with _lock:
        return dict(counters)


@contextmanager
def waiting():
    """Around one blocking read of the device: a ``wait`` span and one
    ``host_waits``."""
    count(host_waits=1)
    with section("wait"):
        yield


# ---------------------------------------------------------------------------
# reading spans and device intervals on one clock (seconds)
# ---------------------------------------------------------------------------

Interval = Tuple[float, float]
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The disjoint, sorted union of intervals."""
    out: List[Interval] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def covered(merged: Sequence[Interval], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the disjoint intervals ``merged`` cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that the disjoint, sorted ``merged`` leave uncovered."""
    out, cur = [], lo
    for a, b in merged:
        if b <= cur or a >= hi:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def device_intervals(prof) -> List[Tuple[str, str, float, float]]:
    """(category, name, start, end) of every kernel, memcpy and memset of a
    ``torch.profiler`` run's Chrome trace, in wall-clock seconds."""
    fd, path = tempfile.mkstemp(prefix="zkt-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    out = []
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e:
            start = (float(e["ts"]) + base_us) / 1e6
            out.append((e["cat"], e.get("name", "?"), start, start + float(e["dur"]) / 1e6))
    return out


def paths(spans: Sequence[Span]) -> Dict[int, str]:
    """Each span's path of names from its root (``prove/round3/commit``), by
    span index."""
    by_index = {s.index: s for s in spans}
    out: Dict[int, str] = {}

    def path(s) -> str:
        if s.index not in out:
            parent = by_index.get(s.parent)
            out[s.index] = s.name if parent is None else f"{path(parent)}/{s.name}"
        return out[s.index]

    for s in spans:
        path(s)
    return out


def own_intervals(spans: Sequence[Span]) -> Dict[int, List[Interval]]:
    """Each span's self time: the stretches of it that none of its children cover."""
    children = defaultdict(list)
    for s in spans:
        children[s.parent].append((s.start, s.end))
    return {s.index: gaps(union(children[s.index]), s.start, s.end) for s in spans}


def self_seconds(spans: Sequence[Span]) -> Dict[int, float]:
    """Each span's duration less the part of it that its children cover."""
    return {i: sum(b - a for a, b in own) for i, own in own_intervals(spans).items()}


def innermost(spans: Sequence[Span], names: Dict[int, str], t: float) -> str:
    """The path of the innermost span open at ``t``, or "between"."""
    best = None
    for s in spans:
        if s.start <= t < s.end and (best is None or s.start > best.start):
            best = s
    return "between" if best is None else names[best.index]


def idle_gaps(busy: Sequence[Interval], spans: Sequence[Span], windows: Sequence[Interval],
              top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest stretches of ``windows`` that the card's disjoint
    ``busy`` intervals leave uncovered, each named by the innermost span
    open at its middle."""
    names = paths(spans)
    found = [g for lo, hi in windows for g in gaps(busy, lo, hi)]
    found.sort(key=lambda g: g[0] - g[1])
    return [(innermost(spans, names, (a + b) / 2), b - a) for a, b in found[:top]]
