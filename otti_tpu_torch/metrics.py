# copied from otti_tpu/metrics.py, without the jax profiler hook
"""Lightweight metrics/observability (SURVEY.md §5.1, §5.5).

The reference prints unstructured stage names; here every prover run can
accumulate structured counters (wall time per stage, constraints/s, MSM
points, sumcheck rounds, host<->device transfers) that the CLI surfaces
and out/*.meta.json persists.
"""

from __future__ import annotations

import contextlib
import threading
import time

_local = threading.local()


def _counters() -> dict:
    if not hasattr(_local, "c"):
        _local.c = {}
    return _local.c


def reset():
    _local.c = {}


def snapshot() -> dict:
    return dict(_counters())


def add(name: str, value: float = 1.0):
    c = _counters()
    c[name] = c.get(name, 0.0) + value


@contextlib.contextmanager
def timed(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        add(name + "_s", time.time() - t0)
