"""Window arithmetic: the closed loop, its statistics, interval unions.

The window opens when the first request is issued and closes when the
first request that ends after ``seconds`` ends, so a proof in flight at
the deadline is neither lost nor counted as half.  ``proofs_per_s`` is
every proof completed over all the window's time; ``latency_p50_s`` the
median over all the window's requests of issue to answer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple


@dataclass
class Record:
    k: int  # the k-th request issued in the window
    issued: float
    done: float
    answer: Optional[bytes]  # None: the request raised
    error: str = ""


@dataclass
class Window:
    opened: float
    closed: float
    records: List[Record]

    @property
    def seconds(self) -> float:
        return self.closed - self.opened

    def completed(self) -> List[Record]:
        return [r for r in self.records if r.answer is not None]

    def proofs_per_s(self) -> float:
        return len(self.completed()) / self.seconds

    def latency_p50_s(self) -> float:
        return median([r.done - r.issued for r in self.records])


def closed_loop(serve: Callable[[int], bytes], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """One client: request k is issued when request k - 1 has its answer.
    ``serve(k)`` returns the answer's bytes (or raises)."""
    records: List[Record] = []
    opened = clock()
    deadline = opened + seconds
    k = 0
    while True:
        issued = clock()
        try:
            answer, error = serve(k), ""
        except Exception as exc:  # a failed request counts; the run goes on
            answer, error = None, f"{type(exc).__name__}: {exc}"
        done = clock()
        records.append(Record(k=k, issued=issued, done=done, answer=answer, error=error))
        k += 1
        if done >= deadline:
            return Window(opened=opened, closed=done, records=records)


def median(values: Sequence[float]) -> float:
    s = sorted(values)
    if not s:
        raise ValueError("median of no values")
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of closed intervals."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def clip(intervals: Sequence[Tuple[float, float]], lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    cur = lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out
