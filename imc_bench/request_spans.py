"""What the served request records of itself: ``repro_torch.spans``'s
``RequestSpans``, kept as the request's ``spans``."""


def window_records(run):
    """The request's records whose call lies in the untraced window, from
    its start to its last completion; None where the request keeps no
    spans (the CPU's path, or a program without them) or the window
    completed nothing."""
    spans = getattr(run.request, "spans", None)
    w = run.window
    if spans is None or not w.complete:
        return None
    return spans.records(w.start, w.complete[-1])
