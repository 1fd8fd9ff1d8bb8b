"""``device_idle_pct.frame``: the share of a request's wall time in which
no kernel or copy ran on the card.  The card's busy time a request is the
union of the traced slice's device intervals over its requests; the wall
time a request is the mean over the untraced window, host call to
completion.  With one request outstanding the profiler slows the host's
graph launch, so the traced slice's own wall would count the profiler's
cost as idle."""

from imc_bench import trace


def read(run):
    t, w = run.traced, run.window
    if t is None or not t.ops or not w.complete:
        return None
    busy = trace.busy_seconds(t) / t.requests
    wall = sum(c - d for d, c in zip(w.dispatch, w.complete)) / len(w.complete)
    return 100.0 * (1.0 - busy / wall)
