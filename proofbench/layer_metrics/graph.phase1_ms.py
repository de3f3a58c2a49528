"""The captured chain's phase 1 (hybrid._stage "matvecs" and "zk_phase1"),
device time from CUDA events in the graph: the program's ``matvecs_dev_s``
and ``zk_phase1_dev_s`` counters, summed, a window request's mean."""

KEYS = ("matvecs_dev_s", "zk_phase1_dev_s")


def read(record: dict):
    reqs = record["requests"]
    if not reqs or any(k not in r["counters"] for r in reqs for k in KEYS):
        return None
    return 1e3 * sum(r["counters"][k] for r in reqs for k in KEYS) / len(reqs)
