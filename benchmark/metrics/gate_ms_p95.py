"""gate_ms_p95: the 95th percentile of every gate's latency in the window,
from the call to the synchronise returning."""

import statistics


def read(run):
    lat = run.window.get("latencies_ms")
    if not lat or len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
