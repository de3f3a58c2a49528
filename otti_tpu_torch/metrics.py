# copied from otti_tpu/metrics.py, without the jax profiler hook; timed takes
# the perf_counter clock and opens a torch.profiler range while one records
"""Lightweight metrics/observability (SURVEY.md §5.1, §5.5).

The reference prints unstructured stage names; here every prover run can
accumulate structured counters (wall time per stage, constraints/s, MSM
points, sumcheck rounds, host<->device transfers) that the CLI surfaces
and out/*.meta.json persists.  While a torch profiler records, ``timed``
also opens a ``record_function`` range of the counter's name, so that a
span sits in the same trace, on the same clock, as the device's work; with
no profiler that costs one flag check.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

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
    """Adds the block's wall seconds to ``<name>_s``; a profiler range
    ``name`` around it while a profiler records."""
    span = record_function(name) if _profiler._is_profiler_enabled else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with span:
            yield
    finally:
        add(name + "_s", time.perf_counter() - t0)
