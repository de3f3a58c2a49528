"""The captured chain's inter-phase section (hybrid._stage "zk_mid"),
device time from CUDA events in the graph: the program's ``zk_mid_dev_s``
counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("zk_mid_dev_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
