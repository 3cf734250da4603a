"""The 95th percentile, over every sgt of the window, of the host time
around its ``ingest`` call, result decode included (ms)."""
import statistics


def read(run):
    if len(run.latencies_s) < 20:
        return None
    return statistics.quantiles(run.latencies_s, n=20)[18] * 1e3
