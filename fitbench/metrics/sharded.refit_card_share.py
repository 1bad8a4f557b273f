"""Share of the dirty runs the window's publishes re-fitted on the card:
the second tag of the ``span.tree.flush`` rows (runs fitted on a CUDA card)
over their first (runs re-fitted), each summed.  None where the rows carry
no second tag: a program whose flush fits on the host alone."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("span.tree.flush")
    if rows is None or not rows.size or rows.shape[1] < 4:
        return None
    refit = float(np.sum(rows[:, 2]))
    if refit <= 0:
        return None
    return float(np.sum(rows[:, 3])) / refit
