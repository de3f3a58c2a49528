"""The host tail's decode of the fetched limbs (zkfused.assemble_zk_proof):
the program's ``host_decode_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("host_decode_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
