"""Blind draws on the host (hybrid._zk_uploads through fused_prover.prove_zk):
the program's ``blinds_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("blinds_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
