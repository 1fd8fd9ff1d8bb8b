"""``capture_record_s``: host seconds the served request's captures spent
recording their CUDA graphs (``torch.cuda.graph``'s entry, the recording
and the instantiation), summed; ``capture_s`` less this is the warm-up and
the static input's copy."""


def read(run):
    spans = getattr(run.request, "spans", None)
    if spans is None or not spans.captures:
        return None
    return float(sum(c.record_s for c in spans.captures))
