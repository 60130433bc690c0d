"""The MSM's EC kernels, K4a (bucket accumulation, projective and affine
instances) and K4 (complete adds, L = 16 and staged L = 24): device
milliseconds in the trace, per proof."""

KERNELS = (
    "bucket_accumulate_kernel",
    "bucket_accumulate_affine_kernel",
    "ec_add_complete_kernel",
    "ec_add_staged_kernel",
)


def read(trace):
    seconds = trace.kernel_seconds(KERNELS)
    if seconds is None or not trace.proofs:
        return None
    return 1e3 * seconds / trace.proofs
