"""``device_idle_pct.stream``: the share of the traced window in which no
kernel or copy ran on the card, from the union of their intervals.  With
requests in flight the card runs ahead of the host, so the profiler's own
host cost shows only where it stalls the card."""

from imc_bench import trace


def read(run):
    t = run.traced
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(t) / t.seconds)
