"""The share of the window that the replays span on the card, without the
profiler: the program's ``graph_device_s`` counter (CUDA events recorded
on the replay stream just before and just after each graph.replay())
summed over the window's requests, over the window's seconds.  The span
includes the gaps between the graph's nodes (in lp-share1b.mono-zk about
23 of a replay's 151 ms, where the profiler counts 127-128 ms of kernels),
so it reads above the card's kernel-busy share: it bounds that share from
above, and is not the same quantity as 100 - ``device.idle_pct``."""


def read(record: dict):
    vals = [r["counters"].get("graph_device_s") for r in record["requests"]]
    if not vals or None in vals or not record.get("window_s"):
        return None
    return 100.0 * sum(vals) / record["window_s"]
