"""The fused search kernel's share of its roofline: the bytes its launches'
work needs at the card's memory bandwidth (``fitbench/roofline.py``) over
the profiler's time of those launches, per launch."""
from fitbench.roofline import PEAKS


def read(run):
    k = run.kernel
    peak = PEAKS.get(run.card)
    if not k or not peak or not k["launches"] or not k["events"] \
            or k["kernel_s"] <= 0:
        return None
    bound_s = k["bytes"] / k["launches"] / peak["hbm_bytes_per_s"]
    return 100.0 * bound_s / (k["kernel_s"] / k["events"])
