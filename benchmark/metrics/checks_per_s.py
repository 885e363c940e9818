"""checks_per_s: Check() answers that equal the reference's, counted at
the client as they complete inside the window, per second of it."""


def read(run):
    return run.judgement.correct_done_in_window / run.lg["window_s"]
