"""The card's time a replay (fused_prover._run: CUDA events on the replay
stream around graph.replay(), read after the fetch): the program's
``graph_device_s`` counter, a window request's mean."""


def read(record: dict):
    vals = [r["counters"].get("graph_device_s") for r in record["requests"]]
    return 1e3 * sum(vals) / len(vals) if vals and None not in vals else None
