"""call_p95_ms: the 95th percentile of every call's latency in the window,
from the call into the public entry to the synchronize after it (host
clock); Python's statistics.quantiles, exclusive method."""

import statistics


def read(w):
    return 1e3 * statistics.quantiles(w.latencies_s, n=20)[18]
