"""The host's submission of the device chain (fused_prover._run up to the
return of graph.replay(): the static inputs' copies and the graph's
launch): the program's ``submit_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("submit_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
