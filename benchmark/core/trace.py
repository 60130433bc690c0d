"""A window's record: the device's trace, every request's latency, the
host's spans (in the traced run) and the program's counters, from which
``device_ms_per_proof`` and the per-layer readers
(``benchmark/metrics/<name>.py``) read.

The device trace is ``torch.profiler``'s (CUDA activity only, so the
host's ops are not recorded and slowed), exported as a Chrome trace into
``TMPDIR`` and deleted once read.  Its timestamps are microseconds from
``baseTimeNanoseconds`` on the wall clock; the spans are taken on
``perf_counter`` and moved onto the same clock by one offset read at the
window's start.  Everything is kept in seconds on the wall clock.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import window as win

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    proofs: int  # proofs completed in the traced window
    opened: float  # the window, wall-clock seconds
    closed: float
    spans: List[Tuple[str, float, float]]  # the benchmark's host spans
    device_ops: List[Tuple[str, str, float, float]]  # (category, name, start, end)
    launches: int  # the program's launch counter over the window
    aligned: bool = True  # the spans and the device's trace are on one clock
    latencies: List[float] = field(default_factory=list)  # every request's, issue to answer

    @property
    def seconds(self) -> float:
        return self.closed - self.opened

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals.  The profiler records only
        around the window, so this needs neither clock to agree."""
        return win.union([(a, b) for _, _, a, b in self.device_ops])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_ms_per_proof(self) -> Optional[float]:
        """The device's busy milliseconds per completed proof: the card
        time that a proof costs.  None when the window holds no proof or
        the device ran nothing."""
        if not self.proofs or not self.device_ops:
            return None
        return 1e3 * self.busy_s() / self.proofs

    def span_seconds(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.spans if n == name]

    def kernel_seconds(self, names: Sequence[str]) -> Optional[float]:
        """Device seconds of the kernels whose name holds one of ``names``
        as a whole identifier; None when none ran."""
        pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])") for n in names]
        hits = [b - a for cat, name, a, b in self.device_ops
                if cat == "kernel" and any(p.search(name) for p in pats)]
        return sum(hits) if hits else None

    def host_state(self, t: float) -> str:
        for name, a, b in self.spans:
            if a <= t < b:
                return name
        return "between"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps of the window, each named by the host span that
        was open at its middle (none where the clocks disagree)."""
        by_name: Dict[str, float] = defaultdict(float)
        for cat, name, a, b in self.device_ops:
            by_name[short_name(name)] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        if self.aligned:
            gaps = sorted(win.gaps([(a, b) for _, _, a, b in self.device_ops], self.opened,
                                   self.closed), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_state((a + b) / 2), b - a] for a, b in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"<.*", "", base.split("(", 1)[0]).strip()
    return base.removeprefix("void ").strip() or name


class DeviceProfiler:
    """``torch.profiler`` over CUDA activity, started before the window."""

    def __init__(self, torch):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def device_ops(self) -> List[Tuple[str, str, float, float]]:
        fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return device_ops_of(data)


def device_ops_of(data: dict) -> List[Tuple[str, str, float, float]]:
    """(category, name, start, end) of every device interval of a Chrome
    trace, in wall-clock seconds."""
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    out = []
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e:
            start = (float(e["ts"]) + base_us) / 1e6
            out.append((e["cat"], e.get("name", "?"), start, start + float(e["dur"]) / 1e6))
    return out


def aligned(ops, opened: float, closed: float) -> bool:
    """Whether at least half of the device's operations fall in the window
    [opened, closed] on the wall clock: if not, the trace's clock is not
    the wall clock that the spans were moved onto."""
    inside = sum(1 for _, _, a, b in ops if b > opened and a < closed)
    return 2 * inside >= len(ops)


def wall_offset() -> float:
    """wall clock minus ``perf_counter``, in seconds."""
    return time.time() - time.perf_counter()
