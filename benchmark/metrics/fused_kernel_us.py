"""fused_kernel_us: the mean device time of one mega-kernel launch in the
traced window, from the profiler's trace."""


def read(run):
    d = run.trace.kernel_durations() if run.trace is not None else []
    return 1e6 * sum(d) / len(d) if d else None
