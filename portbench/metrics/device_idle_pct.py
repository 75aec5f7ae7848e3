"""device_idle_pct: the share of the traced window in which the profiler
shows no kernel, copy or memset on the card."""


def read(run):
    if run.trace is None or run.device != "cuda":
        return None
    window = run.trace.window_s()
    if window <= 0 or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / window)
