"""The per-layer metrics that read the program's spans and CUDA-event
counters: each reader on a synthetic record, and None where its counter is
missing; the cells each is reported in; and trace.summarize's arithmetic,
which the program's spans leave alone but for the idle gaps' labels (the
trace hands summarize the spans named in trace.SPANS)."""

import pytest

from proofbench import cell as cell_mod
from proofbench import trace

# metric: {counter: (request 1, request 2)} and the value (ms, or %)
READERS = {
    "prover.transcript_ms": ({"transcript_s": (0.002, 0.004)}, 3.0),
    "prover.inputs_ms": ({"inputs_s": (0.010, 0.020)}, 15.0),
    "graph.submit_ms": ({"submit_s": (0.004, 0.006)}, 5.0),
    "graph.fetch_ms": ({"fetch_s": (0.150, 0.130)}, 140.0),
    "prover.tail_decode_ms": ({"host_decode_s": (0.001, 0.003)}, 2.0),
    "prover.tail_sigma_ms": ({"host_sigma_s": (0.050, 0.070)}, 60.0),
    "prover.tail_serialize_ms": ({"host_serialize_s": (0.002, 0.002)}, 2.0),
    "graph.device_ms": ({"graph_device_s": (0.140, 0.160)}, 150.0),
    "device.graph_span_pct": ({"graph_device_s": (0.140, 0.160)}, 50.0),  # of a 0.6 s window
    "graph.commit_ms": ({"commit_dev_s": (0.010, 0.012)}, 11.0),
    "graph.phase1_ms": ({"matvecs_dev_s": (0.001, 0.003), "zk_phase1_dev_s": (0.030, 0.040)},
                        37.0),
    "graph.mid_ms": ({"zk_mid_dev_s": (0.020, 0.024)}, 22.0),
    "graph.phase2_ms": ({"m_table_dev_s": (0.002, 0.002), "zk_phase2_dev_s": (0.040, 0.050)},
                        47.0),
    "graph.opening_ms": ({"eval_at_dev_s": (0.003, 0.005), "opening_dev_s": (0.010, 0.012)},
                         15.0),
    "graph.exchange_ms": ({"exchange_dev_s": (0.100, 0.140)}, 120.0),
}
CELLS = ("lp-share1b.mono-zk", "lp-25fv47.mono-zk", "lp-25fv47.ranks4-zk")


def _record(counters: dict) -> dict:
    reqs = [{"wall_s": 0.3, "ok": True, "counters": {"blinds_s": 0.003}} for _ in range(2)]
    for key, vals in counters.items():
        for r, v in zip(reqs, vals):
            r["counters"][key] = v
    return {"setup_s": 20.0, "window_s": 0.6, "requests": reqs, "trace": None}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_on_a_synthetic_record_and_without_its_counter(metric):
    counters, want = READERS[metric]
    read = cell_mod.load("lp-25fv47.ranks4-zk").reader("layer_metrics", metric)
    assert read(_record(counters)) == pytest.approx(want)
    for key in counters:
        rec = _record(counters)
        rec["requests"][1]["counters"].pop(key)  # a program without the counter
        assert read(rec) is None
    assert read({"setup_s": 1.0, "window_s": 0.0, "requests": [], "trace": None}) is None
    cells = [c for c in CELLS if metric in [m["name"] for m in cell_mod.load(c).per_layer]]
    assert cells == (["lp-25fv47.ranks4-zk"] if metric == "graph.exchange_ms" else list(CELLS))


def test_program_spans_change_only_the_idle_gaps_labels():
    ms = 1_000_000
    bench = [(0, 100 * ms, "request"), (0, 1 * ms, "pool_step"), (1 * ms, 100 * ms, "prove_zk")]
    program = [(1 * ms, 3 * ms, "blinds"), (3 * ms, 8 * ms, "transcript"),
               (8 * ms, 20 * ms, "inputs"), (20 * ms, 70 * ms, "device_chain"),
               (20 * ms, 21 * ms, "submit"), (21 * ms, 70 * ms, "fetch"),
               (70 * ms, 100 * ms, "host_tail"), (71 * ms, 99 * ms, "host_sigma")]
    ops = [(21 * ms, 40 * ms, "k1"), (40 * ms + 5000, 69 * ms, "k2"),
           (69 * ms, 70 * ms, "Memcpy DtoH"), (150 * ms, 160 * ms, "after the window")]
    assert {name for _, _, name in bench + program} <= set(trace.SPANS)  # events() keeps them
    plain, spanned = trace.summarize(ops, bench), trace.summarize(ops, bench + program)
    for key in ("requests", "window_s", "busy_s", "launches", "device_ops"):
        assert spanned[key] == plain[key], key
    gaps, labelled = dict(plain["idle_gaps"][:2]), dict(spanned["idle_gaps"])
    assert set(gaps) == {"prove_zk:host", "prove_zk:node_gaps"}
    assert gaps["prove_zk:host"] == pytest.approx(0.051)  # 0-21 ms and 70-100 ms
    assert labelled["inputs:host"] == pytest.approx(0.021)  # the innermost span at a gap's middle
    assert labelled["host_sigma:host"] == pytest.approx(0.030)
    assert labelled["fetch:node_gaps"] == pytest.approx(5e-6)
    assert "prove_zk:host" not in labelled
