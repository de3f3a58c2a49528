"""The captured chain's witness commitment (fused_prover._absorb_rows and
the tau squeeze, hybrid._stage "commit"), device time from CUDA events in
the graph: the program's ``commit_dev_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("commit_dev_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
