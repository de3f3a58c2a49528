"""The harness: cells found by name in files added alone, the result line's
keys, the JAX check, and the per-layer arithmetic on a synthetic trace."""

import json
import os
import sys
import types

import pytest

from proofbench import cell as cell_mod
from proofbench import run, trace


def test_new_config_mix_and_metric_are_files_only(toy_root):
    with open(os.path.join(toy_root, "proofbench", "layer_metrics", "toy.requests.py"), "w") as f:
        f.write("def read(record):\n    return float(len(record['requests']))\n")
    with open(os.path.join(toy_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "toy.requests", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "toy",
                               "moves": "proofs_per_s", "workloads": ["toy.toy-mono-zk"]})
    with open(os.path.join(toy_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    c = cell_mod.load("toy.toy-mono-zk", toy_root)
    assert c.config["rows"] == 3 and c.traffic["name"] == "toy-mono-zk" and c.chips == 1
    assert [m["name"] for m in c.end_to_end] == ["proofs_per_s", "setup_s"]
    record = {"setup_s": 1.5, "window_s": 2.0, "trace": None,
              "requests": [{"wall_s": 0.5, "ok": True, "counters": {}}] * 3}
    got = run.metric_values(c, "layer_metrics", record)
    assert got["toy.requests"] == {"value": 3.0, "unit": "requests"}
    assert "device.idle_pct" not in got  # no trace: its reader finds nothing
    assert run.metric_values(c, "end_to_end", record) == {
        "proofs_per_s": {"value": 1.5, "unit": "proofs/s"}, "setup_s": {"value": 1.5, "unit": "s"}}
    other = cell_mod.load("lp-share1b.mono-zk", toy_root)
    assert "toy.requests" not in [m["name"] for m in other.per_layer]


def test_unknown_workload_refused(toy_root):
    with pytest.raises(KeyError):
        cell_mod.load("toy.nothing", toy_root)


def test_result_line_keys_and_checks_last(toy_root):
    c = cell_mod.load("lp-share1b.mono-zk", toy_root)
    record = {"setup_s": 20.0, "window_s": 30.0, "requests": [
        {"wall_s": 0.25, "ok": True, "counters": {}} for _ in range(120)], "trace": None}
    res = run.result(c, record, False, {"proofs_rejected": (0, 0), "rows_unsatisfied": (0, 0)},
                     {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1})
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] and res["attempted"] == 120 and res["failed"] == 0
    assert set(res["metrics"]) == {"proofs_per_s", "prove_p90_s", "setup_s"}
    assert res["metrics"]["prove_p90_s"]["value"] == pytest.approx(0.25)
    bad = run.result(c, record, False, {"proofs_rejected": (1, 0)}, res["device"])
    assert not bad["correct"] and bad["checks"] == {"proofs_rejected": {"value": 1, "limit": 0}}


@pytest.mark.parametrize("name, flagged", [("jax.numpy", True), ("otti_tpu.cli", True),
                                           ("jaxlib", True), ("flax.linen", True),
                                           ("otti_tpu_torch.cli", False), ("jaxtyping", False)])
def test_jax_check_compares_whole_top_level_names(name, flagged, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in run.jax_modules()) == flagged
    res = {"checks": {}, "correct": True}
    assert run.emit(res) == (run.EXIT_JAX if flagged else 0)
    out = capsys.readouterr().out
    assert (out == "") == flagged


def _record(ops, spans):
    return {"requests": [], "trace": trace.summarize(ops, spans)}


def test_layer_arithmetic_on_a_synthetic_trace(toy_root):
    ms = 1_000_000
    spans = [(0, 100 * ms, "request"), (0, 1 * ms, "pool_step"), (1 * ms, 100 * ms, "prove_zk"),
             (100 * ms, 200 * ms, "request"), (101 * ms, 200 * ms, "prove_zk")]
    # per request: kernels at [20, 40) and [30, 60) ms (overlapping) and a memcpy at 90-95
    ops = []
    for base in (0, 100 * ms):
        ops += [(base + 20 * ms, base + 40 * ms, "k1"), (base + 30 * ms, base + 60 * ms, "k2"),
                (base + 60 * ms + 5000, base + 61 * ms, "k1"),
                (base + 90 * ms, base + 95 * ms, "Memcpy DtoH")]
    ops.append((300 * ms, 310 * ms, "after the window"))
    tr = trace.summarize(ops, spans)
    assert tr["requests"] == 2 and tr["window_s"] == pytest.approx(0.2)
    assert tr["busy_s"] == pytest.approx(2 * (0.040 + 0.000995 + 0.005))
    assert tr["launches"] == 6
    c = cell_mod.load("lp-share1b.mono-zk", toy_root)
    rec = {"requests": [], "trace": tr}
    assert c.reader("layer_metrics", "kernels.busy_ms")(rec) == pytest.approx(45.995)
    assert c.reader("layer_metrics", "device.idle_pct")(rec) == pytest.approx(
        100 * (1 - 0.09199 / 0.2))
    assert c.reader("layer_metrics", "device.launches_per_proof")(rec) == 3
    gaps = dict((k, v) for k, v in tr["idle_gaps"] if ":" in k)
    assert gaps["prove_zk:node_gaps"] == pytest.approx(2 * 5e-6)
    assert gaps["prove_zk:host"] == pytest.approx(2 * (0.020 + 0.029 + 0.005))
    assert tr["device_ops"][0] == ["k2", pytest.approx(0.06)]


def test_counter_metrics_and_prefix_by_subtraction(toy_root):
    c = cell_mod.load("lp-share1b.mono-zk", toy_root)
    reqs = [{"wall_s": 0.3, "ok": True, "counters": {"blinds_s": 0.01, "device_chain_s": 0.15,
                                                     "host_tail_s": 0.06}},
            {"wall_s": 0.2, "ok": True, "counters": {"blinds_s": 0.01, "device_chain_s": 0.13,
                                                     "host_tail_s": 0.04}}]
    rec = {"requests": reqs, "trace": None}
    read = lambda m: c.reader("layer_metrics", m)(rec)  # noqa: E731
    assert read("prover.blinds_ms") == pytest.approx(10)
    assert read("graph.replay_ms") == pytest.approx(140)
    assert read("prover.tail_ms") == pytest.approx(50)
    assert read("prover.prefix_ms") == pytest.approx(50)
    reqs[1]["counters"].pop("host_tail_s")
    assert read("prover.prefix_ms") is None and read("prover.tail_ms") is None
