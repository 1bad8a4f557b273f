"""The harness's span around the service's construction (fit, snapshot, the
LSM's run upload) and its warm-up (upload, kernel load, one call a verb at
each of the cell's sizes)."""


def read(run):
    parts = run.setup_parts
    return parts["service_s"] + parts["warm_s"]
