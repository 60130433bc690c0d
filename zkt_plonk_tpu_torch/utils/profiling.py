"""Timing instrumentation (the reference's ark-std print-trace equivalent).

Enable with env ``ZKT_PLONK_TIMING=1`` or ``timing_enable()``; sections
print nested wall-clock timings to stderr.  A section given ``sync=`` (a
torch device) synchronizes it at exit, so the numbers reflect the card's
work and not its queueing.  Disabled, a section does nothing.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_ENABLED = os.environ.get("ZKT_PLONK_TIMING", "0") not in ("", "0")
_depth = 0


def timing_enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


@contextmanager
def section(name: str, sync=None):
    """Time a section; ``sync`` may be a torch device to synchronize."""
    global _depth
    if not _ENABLED:
        yield
        return
    indent = "  " * _depth
    _depth += 1
    t0 = time.time()
    try:
        yield
    finally:
        if sync is not None and getattr(sync, "type", None) == "cuda":
            import torch

            torch.cuda.synchronize(sync)
        _depth -= 1
        print(f"[timing] {indent}{name}: {(time.time() - t0) * 1e3:.1f} ms", file=sys.stderr)
