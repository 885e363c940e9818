"""device_idle_pct: the share of the traced window in which nothing ran
on the card: no kernel, copy or set of any thread (the union of their
intervals in the profiler's trace)."""


def read(run):
    t = run.trace
    if t is None or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
