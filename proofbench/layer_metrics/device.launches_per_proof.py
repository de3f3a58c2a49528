"""Kernels the profiler saw run on the card a traced request (a captured
graph's nodes each count)."""


def read(record: dict):
    tr = record.get("trace")
    return tr["launches"] / tr["requests"] if tr and tr.get("launches") else None
