"""The host tail's blinded opening and sigma proofs
(zknizk._opening_and_final_zk through zkfused.assemble_zk_proof): the
program's ``host_sigma_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("host_sigma_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
