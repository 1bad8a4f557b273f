"""Device time of the copies in and out (host to device, device to host)
per read call, from the profiler's trace of the window."""


def read(run):
    t = run.trace
    if t is None or not t["read_calls"] or t["read_memcpy_s"] <= 0:
        return None
    return t["read_memcpy_s"] / t["read_calls"] * 1e3
