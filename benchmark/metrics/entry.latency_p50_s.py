"""The entry's latency: the median, over all of the traced window's
requests, of issue to returned proof bytes (host clock)."""

from benchmark.core import window as win


def read(trace):
    return win.median(trace.latencies) if trace.latencies else None
