"""The captured chain's evaluations and opening materials (hybrid._stage
"eval_at" and "opening"), device time from CUDA events in the graph: the
program's ``eval_at_dev_s`` and ``opening_dev_s`` counters, summed, a
window request's mean."""

KEYS = ("eval_at_dev_s", "opening_dev_s")


def read(record: dict):
    reqs = record["requests"]
    if not reqs or any(k not in r["counters"] for r in reqs for k in KEYS):
        return None
    return 1e3 * sum(r["counters"][k] for r in reqs for k in KEYS) / len(reqs)
