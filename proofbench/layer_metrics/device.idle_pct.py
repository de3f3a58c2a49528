"""The share of the traced window in which no operation ran on the card."""


def read(record: dict):
    tr = record.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr and tr.get("busy_s") else None
