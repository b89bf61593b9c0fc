"""95th percentile of submit-to-result seconds over every request that
completed in the window (closed loop; the count is printed beside it)."""

import statistics
import sys


def read(run):
    lat = run.window["latencies"]
    if len(lat) < 20:
        return None
    print(f"service.latency_p95_s over {len(lat)} requests", file=sys.stderr)
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
