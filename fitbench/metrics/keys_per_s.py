"""Keys answered plus keys written (inserted), all of the
window's, over the window's seconds on the host's clock."""


def read(run):
    out = run.outcome
    if out.window_s <= 0:
        return None
    return (out.read_keys + out.write_keys) / out.window_s
