"""The SDP configuration: its cell loads, the SDP generator plants an
optimum and gives the same SDP for the same seed, and a toy-size ``sdp`` cell
runs through the harness on the CPU, correct, and not correct under the
``witness`` control."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from proofbench import cell as cell_mod
from proofbench import run, sdpgen

from .conftest import REPO, make_root


def test_sdp_control2_cell_loads():
    c = cell_mod.load("sdp-control2.mono-zk")
    assert c.kind.__name__ == "proofbench.kinds.sdp" and c.route.VERIFIER == "verify"
    assert (c.config["m"], c.config["blocks"], c.chips) == (66, [20, 10], 1)
    assert c.config["published"] == {"m": 66, "blocks": [20, 10]}
    assert c.config["statement"]["epsilon"] == 0.01 and c.config["statement"]["cap_bits"] == 17
    assert c.traffic["name"] == "mono-zk" and c.traffic["k"] == 1
    assert [m["name"] for m in c.end_to_end] == ["proofs_per_s", "setup_s"]
    assert "graph.exchange_ms" not in [m["name"] for m in c.per_layer]
    assert "prover.inputs_ms" in [m["name"] for m in c.per_layer]


@pytest.mark.parametrize("m, blocks", [(4, [3, 2]), (66, [20, 10])])
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_sdp_has_the_published_shape_and_a_planted_optimum(m, blocks, seed):
    sdp = sdpgen.make_sdp(m, blocks, seed, index=seed % 3)
    n = sum(blocks)
    assert len(sdp.A) == m and sdp.C.shape == (n, n) and sdp.b.shape == (m,)
    inside = np.zeros((n, n), bool)
    off = 0
    for nk in blocks:
        inside[off:off + nk, off:off + nk] = True
        off += nk
    for M in [sdp.C, sdp.X] + sdp.A:
        assert np.array_equal(M, M.T) and not M[~inside].any()
    for Ai in sdp.A:
        vals = np.unique(Ai[Ai != 0])
        assert set(vals) <= set(range(-3, 4)) - {0}
    assert (np.diag(sdp.A[0]) >= 1).all()  # the weighted trace
    Z = sdp.C - sum(yi * Ai for yi, Ai in zip(sdp.y, sdp.A))
    assert np.linalg.eigvalsh(sdp.X).min() > -1e-9 and np.linalg.eigvalsh(Z).min() > -1e-9
    assert np.linalg.eigvalsh(sdp.X + Z).min() > 0.5  # strictly complementary
    assert np.allclose([(Ai * sdp.X).sum() for Ai in sdp.A], sdp.b)
    assert abs((sdp.C * sdp.X).sum() - sdp.b @ sdp.y) < 1e-9 * max(1.0, abs(sdp.b @ sdp.y))


def test_same_seed_same_sdp_other_seed_or_index_other_sdp(tmp_path):
    a, b = sdpgen.make_sdp(66, [20, 10], 5, 0), sdpgen.make_sdp(66, [20, 10], 5, 0)
    assert all(np.array_equal(x, y) for x, y in zip(a.A + [a.C, a.b], b.A + [b.C, b.b]))
    for other in (sdpgen.make_sdp(66, [20, 10], 6, 0), sdpgen.make_sdp(66, [20, 10], 5, 1)):
        assert not np.array_equal(a.C, other.C) and not np.array_equal(a.b, other.b)
    paths = [str(tmp_path / f"{k}.dat-s") for k in "ab"]
    for path, s in zip(paths, (a, b)):
        sdpgen.write_dats(path, "x", [20, 10], s.C, s.A, s.b)
    assert open(paths[0]).read() == open(paths[1]).read()


def test_sdp_file_parses_back_exactly(tmp_path):
    from otti_tpu_torch.io import sdpa

    sdp = sdpgen.make_sdp(66, [20, 10], 2**40 + 1, 1)
    path = str(tmp_path / "c2.dat-s")
    sdpgen.write_dats(path, "c2", [20, 10], sdp.C, sdp.A, sdp.b)
    prob = sdpa.parse_dats(path)
    assert (prob.n, prob.m) == (30, 66)
    assert np.array_equal(prob.C, sdp.C) and np.array_equal(prob.b, sdp.b)
    assert all(np.array_equal(x, y) for x, y in zip(prob.A, sdp.A))


def test_sdp_shapes_refused():
    for m, blocks in ((0, [2]), (1, []), (1, [1, 2])):
        with pytest.raises(ValueError):
            sdpgen.make_sdp(m, blocks, 1)


@pytest.fixture
def sdp_root(tmp_path):
    """The benchmark's copy with ``toy-sdp.toy-mono-zk``: sdp-control2's
    file at one block of 2 and m = 1 (1,886 constraints, 2^11)."""
    root = make_root(str(tmp_path / "root"))
    with open(os.path.join(REPO, "proofbench", "configs", "sdp-control2.json")) as f:
        cfg = json.load(f)
    cfg.update(m=1, blocks=[2], pool=1, verify_sample=1)
    with open(os.path.join(root, "proofbench", "configs", "toy-sdp.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-sdp", "source": "https://eprint.iacr.org/2021/1436",
                             "file": "proofbench/configs/toy-sdp.json", "reduced": ["m"],
                             "why": "a toy SDP for the CPU tests"})
    bench["workloads"].append({"name": "toy-sdp.toy-mono-zk", "config": "toy-sdp",
                               "traffic": "toy-mono-zk", "chips": 1, "why": "the CPU tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("fault", [None, "witness"])
def test_toy_sdp_cell_runs(sdp_root, fault):
    c = cell_mod.load("toy-sdp.toy-mono-zk", sdp_root)
    res = run.run_single(c, 2**31 + 9, 0.5, False, torch.device("cpu"), t0=time.time(),
                         workers=1, fault=fault)
    assert res["attempted"] >= 1 and res["checks"]["instances_differing"]["value"] == 0
    if fault is None:
        assert res["correct"] and res["failed"] == 0
    else:
        assert not res["correct"]
        assert res["checks"]["rows_unsatisfied"]["value"] >= 1
        assert res["checks"]["proofs_rejected"]["value"] >= 1


def test_sdp_reference_imports_nothing_of_the_program():
    code = ("import sys; import proofbench.reference.sdp_lowering, proofbench.sdpgen; "
            "import proofbench.cell as c; k = c.load('sdp-control2.mono-zk').kind; "
            "k.reference(dict(m=4, blocks=[3, 2], statement=dict(epsilon=0.01, cap_bits=17)), 0, 0); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('otti_tpu', 'otti_tpu_torch', 'jax', 'jaxlib', 'torch')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
