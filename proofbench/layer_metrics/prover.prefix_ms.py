"""What a window request spends outside the blinds, the device chain and
the host tail: the transcript prefix (hybrid_sharded._start) and the
core's inputs (fused_prover._inputs), derived by subtraction from the
request's wall time, a request's mean."""

KEYS = ("blinds_s", "device_chain_s", "host_tail_s")


def read(record: dict):
    reqs = record["requests"]
    if not reqs or any(k not in r["counters"] for r in reqs for k in KEYS):
        return None
    return 1e3 * sum(r["wall_s"] - sum(r["counters"][k] for k in KEYS) for r in reqs) / len(reqs)
