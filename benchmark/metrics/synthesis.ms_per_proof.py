"""Circuit synthesis: host milliseconds of ``ZKTPlonk.statement`` (the
witness of one request in proving mode, and the seeded transcript), per
proof, from the benchmark's span around the call."""


def read(trace):
    spans = trace.span_seconds("statement")
    return 1e3 * sum(spans) / len(spans) if spans else None
