"""Proofs completed in the window over the window's seconds (the window
ends with the last request's proof on the host)."""


def read(record: dict):
    return sum(r["ok"] for r in record["requests"]) / record["window_s"]
