"""Process start to the first timed call: data, fit, upload, requests and
warm-up."""


def read(run):
    return run.setup_s
