"""``mfu_pct``: the model's operations a frame (the configuration's frozen
count) times the frames of the traced slice, over the slice's wall time
times the configuration's peak."""


def read(run):
    t = run.traced
    if t is None or not t.ops:
        return None
    cfg = run.cell.config
    return 100.0 * cfg["ops_per_frame"] * t.frames / (t.seconds * cfg["peak_ops_per_s"])
