"""A cell of BENCHMARK.json with its configuration, traffic mix and metric
readers, each found by name among the benchmark's files."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the harness reads of a traffic mix; a mix with another key is refused,
# so that no setting is silently left unread
TRAFFIC_KEYS = {"route", "k", "ranks", "trace_requests"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with "name"
    traffic: dict  # traffic/<mix>.json, with "name"
    end_to_end: list  # this cell's end-to-end metrics (BENCHMARK.json entries)
    per_layer: list  # this cell's per-layer metrics
    root: str

    def reader(self, kind: str, metric: str):
        """``read(record) -> float | None`` of <kind>/<metric>.py, ``kind``
        "end_to_end" or "layer_metrics"."""
        path = os.path.join(self.root, "proofbench", kind, metric + ".py")
        spec = importlib.util.spec_from_file_location(f"proofbench_{kind}_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load(workload: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_json(os.path.join(root, conf["file"])), name=conf["name"])
    traffic = _json(os.path.join(root, "proofbench", "traffic", w["traffic"] + ".json"))
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"traffic {w['traffic']!r} has the keys {sorted(traffic)}, "
                         f"not {sorted(TRAFFIC_KEYS)}")
    traffic["name"] = w["traffic"]
    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _in_cell(m, workload)], root=root)
