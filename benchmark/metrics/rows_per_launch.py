"""rows_per_launch: device rows per mega-kernel launch of the native
frontend in the window (its counters' deltas; none where nothing
launched)."""


def read(run):
    d = run.window_counts()
    if d is None or not d.get("fe_launches"):
        return None
    return d["fe_device_rows"] / d["fe_launches"]
