"""air_transition_roofline: the share of K4's (air_transition) device
time in the traced window that the AIR slices of the window's proofs need
at the card's published bandwidth (roofline.air_bytes, from each proof's
geometry)."""

import roofline

KERNEL = "air_transition_kernel"


def read(run):
    if run.trace is None or run.kind not in roofline.PEAKS:
        return None
    seconds = run.trace.device_seconds(KERNEL)
    if seconds <= 0:
        return None
    least = len(run.requests) * roofline.air_bytes(
        run.trace_length, run.registers) / roofline.peak_bytes_per_s(run.kind)
    return 100.0 * least / seconds
