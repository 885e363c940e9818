"""fused_kernel_roofline_pct: the least time the mega-kernel's work needs
over the time it took, as a percentage.

The work is the benchmark's own count, whatever implements the kernel
(the own-config rule): each device row reads its request's values that
its AuthConfig's leaves read and those leaves as records, and writes one
verdict (the configuration's ``row_work``), averaged over the payload
set.  Rows per launch come from the frontend's counters over the window,
the time per launch from the profiler's trace.  The least
time is the larger of bytes over the card's memory bandwidth and
operations over its INT32 rate (``peaks.json``)."""


def read(run):
    d = run.window_counts()
    times = run.trace.kernel_durations() if run.trace is not None else []
    if not times or d is None or not d.get("fe_launches"):
        return None
    peaks, work = run.peaks(), run.work_per_row()
    if peaks is None or work is None:
        return None
    rows = d["fe_device_rows"] / d["fe_launches"]
    bytes_per_row, ops_per_row = work
    least = max(rows * bytes_per_row / peaks["hbm_bytes_per_s"],
                rows * ops_per_row / peaks["int32_ops_per_s"])
    return 100.0 * least / (sum(times) / len(times))
