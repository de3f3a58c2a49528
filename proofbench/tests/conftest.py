"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary root with a toy configuration (an LP of 3 x 5, 2^9 padded
constraints), added as files and BENCHMARK.json entries only."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's cells run on the card")


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_root(path: str) -> str:
    """A benchmark root at ``path``: BENCHMARK.json, proofbench/ (without
    its tests) and the program, with the toy cells ``toy.toy-mono-zk``,
    ``toy.toy-ranks2-zk`` and ``toy.toy-cli-zk`` added."""
    shutil.copytree(os.path.join(REPO, "proofbench"), os.path.join(path, "proofbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "otti_tpu_torch"), os.path.join(path, "otti_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(REPO, "proofbench", "configs", "lp-share1b.json")) as f:
        cfg = json.load(f)
    cfg.update(rows=3, cols=5, nnz=8, pool=1, verify_sample=1)
    with open(os.path.join(path, "proofbench", "configs", "toy.json"), "w") as f:
        json.dump(cfg, f)
    mixes = {"toy-mono-zk": dict(route="fused_prover", k=1, ranks=1, trace_requests=1),
             "toy-ranks2-zk": dict(route="fused_prover", k=2, ranks=2, trace_requests=1),
             "toy-cli-zk": dict(route="cli", k=1, ranks=1, trace_requests=1)}
    for name, mix in mixes.items():
        with open(os.path.join(path, "proofbench", "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    bench["configs"].append({"name": "toy", "source": "https://www.netlib.org/lp/data/readme",
                             "file": "proofbench/configs/toy.json", "reduced": ["rows"],
                             "why": "a toy LP for the CPU tests"})
    for mix, chips in (("toy-mono-zk", 1), ("toy-ranks2-zk", 2), ("toy-cli-zk", 1)):
        bench["workloads"].append({"name": f"toy.{mix}", "config": "toy", "traffic": mix,
                                   "chips": chips, "why": "the CPU tests"})
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture
def toy_root(tmp_path):
    return make_root(str(tmp_path / "root"))
