"""``latency_p95_ms``: the 95th percentile of every request's wall time in
the window, from the host call until the card has finished it; None
where fewer than 10 requests lie beyond the 95th percentile."""

from imc_bench import stats


def read(run):
    w = run.window
    p = stats.tail_percentile(len(w.complete))
    if p is None or p < 95:
        return None
    return 1e3 * stats.percentile([c - d for d, c in zip(w.dispatch, w.complete)], 95)
