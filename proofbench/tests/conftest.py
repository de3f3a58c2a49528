"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary root with a toy configuration (an LP of 3 x 5, 2^9 padded
constraints), added as files and BENCHMARK.json entries only; and a toy
certificate kind, proof route and reference verifier that ``add_toy_kind``
adds to such a root in the same way."""

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


# kinds/toy_chain.py: a chain of products x[i] x[i+1] = x[i+2], the two
# first numbers drawn from the seed
TOY_KIND = '''"""A toy certificate kind: x[i] x[i+1] = x[i+2] for a chain of
``length`` numbers whose first two are drawn from the seed."""

import numpy as np

from ..reference import lowering

KEYS = ("length",)


def _chain(config, seed, index):
    rng = np.random.default_rng([seed % 2**64, index, 7 << 20])
    x = [int(v) for v in rng.integers(2, 2**62, size=2)]
    while len(x) < config["length"]:
        x.append(x[-2] * x[-1] % lowering.MOD)
    return x


def program(config, seed, index, tmpdir):
    from otti_tpu_torch.spartan.r1cs import R1CSShape

    x = _chain(config, seed, index)
    n = len(x)
    A, B, C = ([(i, i + d, 1) for i in range(n - 2)] for d in range(3))
    return R1CSShape.from_logical(n - 2, n, 0, A, B, C), x, []


def reference(config, seed, index):
    n = len(_chain(config, seed, index))
    return lowering.R1CS(n, [([(i, 1)], [(i + 1, 1)], [(i + 2, 1)]) for i in range(n - 2)])
'''

# routes/toy_hybrid.py: the eager single-device zk prover, no key of its own
TOY_ROUTE = '''"""A toy route: spartan/hybrid.py's prove_zk on this process's device."""

KEYS = ()
VERIFIER = "toy_verify"


def prover(traffic, shape, device, group=None):
    from otti_tpu_torch.spartan import hybrid

    return lambda d, v, i, seed: hybrid.prove_zk(d, v, i, seed=seed)
'''

# reference/toy_verify.py: the route's verifier, found by its name
TOY_VERIFY = '''"""The toy route's verifier: the zk NIZK's."""

from .verify import verify  # noqa: F401
'''


def add_toy_kind(root: str) -> str:
    """Adds, as files and BENCHMARK.json entries only, the kind
    ``toy_chain``, the route ``toy_hybrid`` with its verifier, and the cell
    ``toy-chain.toy-hybrid-zk``; returns the cell's name."""
    pb = os.path.join(root, "proofbench")
    for rel, text in (("kinds/toy_chain.py", TOY_KIND), ("routes/toy_hybrid.py", TOY_ROUTE),
                      ("reference/toy_verify.py", TOY_VERIFY)):
        with open(os.path.join(pb, rel), "w") as f:
            f.write(text)
    with open(os.path.join(pb, "configs", "toy-chain.json"), "w") as f:
        json.dump({"kind": "toy_chain", "length": 64, "pool": 1, "verify_sample": 1}, f)
    with open(os.path.join(pb, "traffic", "toy-hybrid-zk.json"), "w") as f:
        json.dump({"route": "toy_hybrid", "ranks": 1, "trace_requests": 1}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-chain", "source": "https://eprint.iacr.org/2021/1436",
                             "file": "proofbench/configs/toy-chain.json", "reduced": [],
                             "why": "a toy kind for the CPU tests"})
    bench["workloads"].append({"name": "toy-chain.toy-hybrid-zk", "config": "toy-chain",
                               "traffic": "toy-hybrid-zk", "chips": 1, "why": "the CPU tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return "toy-chain.toy-hybrid-zk"
