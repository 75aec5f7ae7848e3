"""ntt_pass_roofline: the share of K1's (ntt_pass) device time in the
traced window that the transforms of the window's proofs need at the
card's published bandwidth (roofline.ntt_bytes, from each proof's
geometry)."""

import roofline

KERNEL = "ntt_pass_kernel"


def read(run):
    if run.trace is None or run.kind not in roofline.PEAKS:
        return None
    seconds = run.trace.device_seconds(KERNEL)
    if seconds <= 0:
        return None
    least = len(run.requests) * roofline.ntt_bytes(
        run.trace_length, run.extension_factor, run.registers) / roofline.peak_bytes_per_s(run.kind)
    return 100.0 * least / seconds
