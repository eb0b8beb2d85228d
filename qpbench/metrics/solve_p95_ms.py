"""The 95th percentile of every solve's time in the window, each from its
issue to the end of its last kernel (host clock around work that ends in a
synchronize)."""

import statistics


def read(run):
    lat = [1e3 * r["latency_s"] for r in run.records]
    return statistics.quantiles(lat, n=20, method="inclusive")[-1]
