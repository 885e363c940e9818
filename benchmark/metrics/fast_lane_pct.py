"""fast_lane_pct: of the Check()s the native frontend took in the window,
the share it answered on its fast lane (no Python pipeline per request):
fast / (fast + slow + notfound) of its counters' deltas."""


def read(run):
    d = run.window_counts()
    if d is None:
        return None
    total = d.get("fast", 0) + d.get("slow", 0) + d.get("notfound", 0)
    return 100.0 * d["fast"] / total if total else None
