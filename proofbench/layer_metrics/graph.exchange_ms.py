"""The exchanges between ranks (hybrid_sharded.all_gather, hybrid._stage
"exchange", summed over a prove, waiting included; rank 0's), device time
from CUDA events in the graph: the program's ``exchange_dev_s`` counter, a
window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("exchange_dev_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
