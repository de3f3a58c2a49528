"""The transcript prefix on the host (hybrid_sharded._start: the instance
absorbed, through fused_prover.prove_zk): the program's ``transcript_s``
counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("transcript_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
