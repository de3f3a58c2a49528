"""The 90th percentile of every window request's latency (statistics'
exclusive quantiles), from 10 requests up."""

import statistics


def read(record: dict):
    walls = [r["wall_s"] for r in record["requests"]]
    return statistics.quantiles(walls, n=10)[8] if len(walls) >= 10 else None
