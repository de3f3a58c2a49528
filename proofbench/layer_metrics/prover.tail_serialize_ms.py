"""The host tail's proof object (zkfused._build_zk_proof_obj): the
program's ``host_serialize_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("host_serialize_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
