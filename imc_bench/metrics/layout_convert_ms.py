"""``layout_convert_ms``: device milliseconds a request of cuDNN's layout
conversions between NHWC and NCHW, by kernel name."""

from imc_bench import trace

PATTERNS = ("nhwcToNchw", "nchwToNhwc")


def read(run):
    t = run.traced
    if t is None or not t.ops:
        return None
    spent = trace.device_seconds(t, lambda o: any(p in o.name for p in PATTERNS))
    return 1e3 * spent / t.requests
