"""``request_device_ms.<part>``: the median device span of the untraced
window's sampled requests, in ms: from a timing event the request records
on its stream before copying its input in to one after copying its output
out (every fourth request); None where no request of the window carries
one."""

import statistics

from imc_bench import request_spans


def read(run):
    recs = request_spans.window_records(run)
    spans = [r.device_s for r in recs or () if r.device_s is not None]
    return 1e3 * statistics.median(spans) if spans else None
