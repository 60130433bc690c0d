"""The NTT kernel K3 (one fused pass per radix step, lazy and strict):
device milliseconds in the trace, per proof."""

KERNELS = ("ntt_fused_pass_kernel",)


def read(trace):
    seconds = trace.kernel_seconds(KERNELS)
    if seconds is None or not trace.proofs:
        return None
    return 1e3 * seconds / trace.proofs
