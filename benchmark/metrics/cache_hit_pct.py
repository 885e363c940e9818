"""cache_hit_pct: of the fast lane's batched rows in the window, the share
the verdict cache answered (cache_rows / rows of the native frontend's
counters' deltas)."""


def read(run):
    d = run.window_counts()
    if d is None or not d.get("fe_rows"):
        return None
    return 100.0 * d["fe_cache_rows"] / d["fe_rows"]
