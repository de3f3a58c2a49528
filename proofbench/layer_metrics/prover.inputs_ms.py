"""The core's inputs on the host (fused_prover: hybrid_sharded._Shards,
_inputs, the blinds tuple, hybrid_sharded._zk_tables): the program's
``inputs_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("inputs_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
