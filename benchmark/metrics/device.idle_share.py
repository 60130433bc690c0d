"""The device's idle share of the traced window: 100 % x (1 - the union
of its kernel, memcpy and memset intervals / the window's wall time)."""


def read(trace):
    if not trace.device_ops or trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.seconds)
