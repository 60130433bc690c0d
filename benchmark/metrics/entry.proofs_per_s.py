"""The entry's rate: every proof completed in the traced window, over all
of the window's time (host clock).  It is ``proofs_per_s`` of the window
under the profiler and the host spans."""


def read(trace):
    if not trace.proofs or trace.seconds <= 0:
        return None
    return trace.proofs / trace.seconds
