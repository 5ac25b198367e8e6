"""Device: the share of the traced jobs' wall time in which no kernel,
copy or set ran on the card (1 - the union of their intervals over the
traced window, ``trace.py``), in %."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
