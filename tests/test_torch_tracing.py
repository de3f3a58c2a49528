"""How the port measures a prove (otti_tpu_torch/metrics.py, hybrid._stage,
parallel/fused_prover.py).

``metrics.timed`` counts on the perf_counter clock and opens a torch.profiler
range of its counter's name only while a profiler records.  One zk prove by
``fused_prover`` on the CPU (the toy random R1CS of
tests/test_torch_fused_prover.py at 16 constraints) leaves a counter for
each host span, the spans cover the prove's wall, and its bytes are those
of the port's single-device ``zknizk.prove`` with the same seed (which
tests/test_torch_zknizk.py holds to the JAX package's bytes).  A stage's
CUDA event pair becomes ``<stage>_dev_s``; the CPU records no event, so the
pairs are stand-ins here (the card's are checked by chip_smoke.py's phase mono).
"""

import contextlib
import itertools
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from otti_tpu_torch import metrics
from otti_tpu_torch.parallel import fused_prover as FP
from otti_tpu_torch.spartan import hybrid, serial, zknizk
from tests.test_torch_fused_prover import _random_r1cs

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

SEED = b"\x5a" * 32
HOST_SPANS = ("blinds", "transcript", "inputs", "submit", "fetch", "host_tail")


def test_timed_counts_on_the_perf_counter_clock(monkeypatch):
    ticks = itertools.count(10.0, 0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    metrics.reset()
    with metrics.timed("stage"):
        pass
    assert metrics.snapshot() == {"stage_s": 0.25}


def test_timed_opens_a_profiler_range_only_while_one_records(monkeypatch):
    opened = []
    real = metrics.record_function
    monkeypatch.setattr(metrics, "record_function", lambda name: opened.append(name) or real(name))
    metrics.reset()
    with metrics.timed("unprofiled"):
        torch.ones(4).add_(1)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.timed("profiled"):
            torch.ones(4).add_(1)
    assert opened == ["profiled"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "profiled" in names and "unprofiled" not in names
    assert set(metrics.snapshot()) == {"unprofiled_s", "profiled_s"}


class _Event:
    """A recorded CUDA event's stand-in: its time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_stage_event_pairs_become_device_counters():
    metrics.reset()
    hybrid._add_stage_times([("commit", _Event(0), _Event(2.5)),
                             ("zk_phase1", _Event(2.5), _Event(10)),
                             ("exchange", _Event(3), _Event(4)),
                             ("exchange", _Event(5), _Event(5.5))])
    assert metrics.snapshot() == pytest.approx(
        {"commit_dev_s": 0.0025, "zk_phase1_dev_s": 0.0075, "exchange_dev_s": 0.0015})


@pytest.mark.parametrize("collecting,device", [(False, "cuda"), (True, "cpu")])
def test_a_stage_records_no_event_outside_a_collection_or_on_the_cpu(collecting, device):
    """Neither case touches CUDA: this machine may have no card."""
    with hybrid._collect() if collecting else contextlib.nullcontext([]) as pairs:
        with hybrid._stage("matvecs", device):
            with hybrid._collect() as inner:
                pass
        assert getattr(hybrid._stages, "pairs", None) is (pairs if collecting else None)
    assert pairs == [] and inner == []
    assert getattr(hybrid._stages, "pairs", None) is None


def test_a_cpu_zk_prove_leaves_every_span_and_its_bytes(monkeypatch):
    opened = []  # the ranges a recording profiler would get, in order
    monkeypatch.setattr(metrics, "_profiler", types.SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(metrics, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    shape, zvars, inputs = _random_r1cs(16, 8, 2, 7)
    dev = shape.to_device("cpu")
    metrics.reset()
    t0 = time.perf_counter()
    proof = FP.prove_zk(dev, zvars, inputs, k=1, seed=SEED, devices=[torch.device("cpu")])
    wall = time.perf_counter() - t0
    assert opened == ["inputs", "blinds", "transcript", "inputs", "device_chain", "submit",
                      "fetch", "host_tail", "host_decode", "host_sigma", "host_serialize"]
    snap = metrics.snapshot()
    assert {n + "_s" for n in opened} <= set(snap)
    assert not [k for k in snap if k.endswith("_dev_s")]  # no event on the CPU
    assert sum(snap[n + "_s"] for n in HOST_SPANS) >= 0.95 * wall
    assert snap["submit_s"] + snap["fetch_s"] <= snap["device_chain_s"]
    assert (snap["host_decode_s"] + snap["host_sigma_s"] + snap["host_serialize_s"]
            <= snap["host_tail_s"])
    # after the counters are read: the reference's own spans would join them
    assert serial.dumps(proof) == serial.dumps(zknizk.prove(dev, zvars, inputs, seed=SEED))
