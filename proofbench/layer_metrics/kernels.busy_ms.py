"""Device time a traced request: the union of the profiler's kernel, memcpy
and memset intervals over the traced window, over its requests."""


def read(record: dict):
    tr = record.get("trace")
    return 1e3 * tr["busy_s"] / tr["requests"] if tr and tr.get("busy_s") else None
