"""One less the share of the traced window in which an operation (kernel,
copy, fill) ran on the card."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
