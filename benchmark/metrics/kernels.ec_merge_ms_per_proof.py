"""The MSM's group merge, K6 (ec_bucket_merge: the chunks' chains and the
chain over their partial sums, L = 16 and 24): device milliseconds in the
trace, per proof.  A program without K6 runs no such kernel, and the
metric is then left out."""

KERNELS = ("ec_bucket_merge_kernel",)


def read(trace):
    seconds = trace.kernel_seconds(KERNELS)
    if seconds is None or not trace.proofs:
        return None
    return 1e3 * seconds / trace.proofs
