"""``launches_per_request.<part>``: kernels in the trace (copies and sets
left out) over the requests traced."""

from imc_bench import trace


def read(run):
    t = run.traced
    if t is None or not t.ops:
        return None
    return sum(1 for o in t.ops if trace.is_kernel(o)) / t.requests
