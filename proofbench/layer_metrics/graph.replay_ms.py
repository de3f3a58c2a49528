"""The device chain (fused_prover._run: the inputs copied in, the graph
replayed, the outputs fetched): the ``device_chain_s`` counter, a window
request's mean."""


def read(record: dict):
    vals = [r["counters"].get("device_chain_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
