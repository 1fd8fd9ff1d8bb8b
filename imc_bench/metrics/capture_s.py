"""``capture_s``: host seconds the served request spent capturing its CUDA
graphs (warm-up included), the sum of its ``capture_seconds``."""


def read(run):
    spans = getattr(run.request, "capture_seconds", None)
    return float(sum(spans)) if spans else None
