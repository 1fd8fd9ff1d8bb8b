"""``frames_per_s``: every frame completed in the window over the window's
wall time, from before the first dispatch to the last completion."""


def read(run):
    w = run.window
    if not w.complete:
        return None
    return len(w.complete) * w.frames_per_request / (w.complete[-1] - w.start)
