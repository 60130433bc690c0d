"""Launch traffic: the program's kernel launches over the traced window
(the change in the sum of ``_cuda.launches``, exact), per proof."""


def read(trace):
    if not trace.proofs or trace.launches <= 0:
        return None
    return trace.launches / trace.proofs
