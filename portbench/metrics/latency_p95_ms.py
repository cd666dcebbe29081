"""latency_p95_ms: the 95th percentile of the window's request latencies,
in ms, over every request: in a closed loop a call's wall from issue to
return (results returned as SearchResult lists), in an open loop a
query's time from arrival to answer. The run prints the median and the
count beside it on standard error."""

import statistics


def read(run):
    if len(run.latency_s) < 2:
        return None
    return statistics.quantiles(run.latency_s, n=20)[18] * 1e3
