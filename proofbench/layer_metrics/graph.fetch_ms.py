"""The packed fetch (fused_prover._run: the wait for the card, the copy to
the host and the unpack): the program's ``fetch_s`` counter, a window
request's mean."""


def read(record: dict):
    vals = [r["counters"].get("fetch_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
