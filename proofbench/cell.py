"""A cell of BENCHMARK.json with its configuration, traffic mix, certificate
kind, proof route and metric readers, each found by name among the
benchmark's files: a configuration's ``kind`` is ``kinds/<kind>.py``, a
traffic's ``route`` is ``routes/<route>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the harness reads of every configuration, besides its kind's KEYS
CONFIG_KEYS = ("kind", "pool", "verify_sample")
# what the harness reads of every traffic mix, besides its route's KEYS; a
# mix with another key is refused, so that no setting is silently left unread
TRAFFIC_KEYS = {"route", "ranks", "trace_requests"}


def load_file(root: str, folder: str, name: str) -> types.ModuleType:
    """proofbench/<folder>/<name>.py under ``root``, loaded by its path as
    ``proofbench.<folder>.<name>``, so that its relative imports reach the
    benchmark's own modules."""
    path = os.path.join(root, "proofbench", folder, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no file proofbench/{folder}/{name}.py under {root}")
    spec = importlib.util.spec_from_file_location(f"proofbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with "name"
    traffic: dict  # traffic/<mix>.json, with "name"
    kind: types.ModuleType  # kinds/<config["kind"]>.py
    route: types.ModuleType  # routes/<traffic["route"]>.py
    end_to_end: list  # this cell's end-to-end metrics (BENCHMARK.json entries)
    per_layer: list  # this cell's per-layer metrics
    root: str

    def reader(self, folder: str, metric: str):
        """``read(record) -> float | None`` of <folder>/<metric>.py, ``folder``
        "end_to_end" or "layer_metrics"."""
        return load_file(self.root, folder, metric).read


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
    if "kind" not in config:
        raise ValueError(f"configuration {conf['name']!r} names no kind")
    kind = load_file(root, "kinds", config["kind"])
    missing = [k for k in CONFIG_KEYS + tuple(kind.KEYS) if k not in config]
    if missing:
        raise ValueError(f"configuration {conf['name']!r} lacks {missing}")
    traffic = _json(os.path.join(root, "proofbench", "traffic", w["traffic"] + ".json"))
    if "route" not in traffic:
        raise ValueError(f"traffic {w['traffic']!r} names no route")
    route = load_file(root, "routes", traffic["route"])
    keys = TRAFFIC_KEYS | set(route.KEYS)
    if set(traffic) != keys:
        raise ValueError(f"traffic {w['traffic']!r} has the keys {sorted(traffic)}, "
                         f"not {sorted(keys)}")
    traffic["name"] = w["traffic"]
    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic, kind=kind,
                route=route,
                end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _in_cell(m, workload)], root=root)
