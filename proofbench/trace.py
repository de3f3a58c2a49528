"""What the profiler saw of the traced requests: the union of the device
operations' intervals, their count, the idle gaps by the host span they
fall in, and the operations that took most time.

Device operations are the profiler's kernel, memcpy and memset records
(NCCL's kernels among them, waiting included); the benchmark's own
``record_function`` spans and the program's (``metrics.timed`` opens one
while a profiler records), the names in ``SPANS``, say what the host was
doing: an idle gap is filed under the innermost span that holds its
middle.  The traced window runs from the first ``request`` span's start to
the last one's end.
"""

from __future__ import annotations

import collections

SPANS = ("request", "pool_step", "prove_zk",  # the benchmark's (serve.Server.request)
         # the program's: parallel/fused_prover.py and spartan/zkfused.py
         "blinds", "transcript", "inputs", "device_chain", "submit", "fetch", "host_tail",
         "host_decode", "host_sigma", "host_serialize")
NODE_GAP_NS = 20_000  # gaps shorter than this lie between a graph's nodes
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}


def union(intervals: list) -> list:
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _is_device_op(e, cuda) -> bool:
    if e.device_type() != cuda or e.is_user_annotation() or e.duration_ns() <= 0:
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or kind() in _DEVICE_KINDS


def events(prof) -> tuple:
    """(device operations as (start, end, name), host spans as (start, end,
    name)) in ns from a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if _is_device_op(e, DeviceType.CUDA):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.device_type() == DeviceType.CPU and e.name() in SPANS:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return ops, spans


def summarize(ops: list, spans: list, top: int = 10) -> dict:
    """busy_s, window_s, launches, device_ops and idle_gaps (the longest
    ``top`` of each) over the traced window."""
    reqs = [s for s in spans if s[2] == "request"]
    if not reqs:
        return {"requests": 0}
    w0, w1 = min(s for s, _, _ in reqs), max(e for _, e, _ in reqs)
    inside = [(max(s, w0), min(e, w1)) for s, e, _ in ops if e > w0 and s < w1]
    busy = union(inside)
    by_name = collections.Counter()
    for s, e, name in ops:
        if e > w0 and s < w1:
            by_name[name[:80]] += (e - s) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    inner = sorted(spans, key=lambda s: s[0])
    totals, singles = collections.Counter(), []
    for s, e in gaps:
        mid = (s + e) // 2
        label = "outside"
        for ss, se, name in inner:  # the innermost: the latest start that holds mid
            if ss <= mid < se:
                label = name
        kind = "node_gaps" if e - s < NODE_GAP_NS else "host"
        totals[f"{label}:{kind}"] += (e - s) / 1e9
        singles.append((f"{label}", (e - s) / 1e9))
    singles.sort(key=lambda x: -x[1])
    idle = [[k, v] for k, v in totals.most_common()]
    idle = (idle + [list(x) for x in singles])[:top]
    return {"requests": len(reqs), "window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "launches": sum(1 for s, _, n in ops
                            if w0 <= s < w1 and not n.startswith(("Memcpy", "Memset"))),
            "device_ops": [[k, v] for k, v in by_name.most_common(top)],
            "idle_gaps": idle}
