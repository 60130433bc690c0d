"""Gate/variable provenance tracing — the ``trace`` cargo feature rebuilt.

The reference (``composer.rs:142-144,214-218``; ``variable.rs:94-126``;
``helper.rs:40-72``) captures a backtrace per gate/variable and prints it
when a gate is unsatisfied.  Here: enable with ``trace_enable()`` (or env
``ZKT_PLONK_TRACE=1``); each gate/variable records a trimmed Python stack
summary, and ``explain_gate`` / the check harness report provenance on
failure.  Timing instrumentation lives in ``utils/profiling.py``.
"""

from __future__ import annotations

import os
import traceback
from typing import List, Optional

_ENABLED = os.environ.get("ZKT_PLONK_TRACE", "0") not in ("", "0")


def trace_enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def trace_enabled() -> bool:
    return _ENABLED


def capture(skip: int = 2, limit: int = 6) -> Optional[List[str]]:
    """Trimmed stack summary (skipping the gate-API frames themselves)."""
    if not _ENABLED:
        return None
    stack = traceback.extract_stack()[:-skip]
    frames = [
        f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
        for f in stack[-limit:]
    ]
    return frames


class GateTrace:
    """Per-gate provenance store attached to a SetupComposer."""

    def __init__(self):
        self.gates: List[Optional[List[str]]] = []

    def record(self):
        self.gates.append(capture(skip=3))

    def explain(self, gate_index: int) -> str:
        if gate_index >= len(self.gates) or self.gates[gate_index] is None:
            return f"gate {gate_index}: no trace recorded (enable with trace_enable())"
        frames = "\n  ".join(self.gates[gate_index])
        return f"gate {gate_index} created at:\n  {frames}"
