"""The prover: host milliseconds of ``Prover.prove`` (rounds, transcript,
staging, every device call, ended by ``torch.cuda.synchronize()``), per
proof, from the benchmark's span around the call."""


def read(trace):
    spans = trace.span_seconds("prove")
    return 1e3 * sum(spans) / len(spans) if spans else None
