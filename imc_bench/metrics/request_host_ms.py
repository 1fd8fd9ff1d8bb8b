"""``request_host_ms.<part>``: the median host time of the untraced
window's requests inside the request object, in ms: its input's copy, the
graph's replay and its output's copy, as the request records them."""

import statistics

from imc_bench import request_spans


def read(run):
    recs = request_spans.window_records(run)
    if not recs:
        return None
    return 1e3 * statistics.median(r.copy_in_s + r.replay_s + r.copy_out_s
                                   for r in recs)
