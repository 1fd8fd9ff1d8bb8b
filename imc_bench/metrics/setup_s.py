"""``setup_s``: seconds from the harness's first line to the first timed
request (imports, the port's kernel build on a checkout's first run,
weights, calibration, programming, capture, warm-up)."""


def read(run):
    return run.setup_s
