"""Whole runs of the harness on the CPU at a toy size (the look for a card
skipped): a sound run comes out correct; with the timed path broken
underneath (the control's wrong witness, an answer altered where it is
produced, the exchange between ranks left out) it comes out not correct;
a rank that fails ends the run; a kind and a route added as files alone
run, and their control fails.  Each takes tens of seconds."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from proofbench import cell as cell_mod
from proofbench import ranks, run

from .conftest import REPO, add_toy_kind

CPU = torch.device("cpu")


def _single(root, fault=None, trace=False, mix="toy-mono-zk"):
    c = cell_mod.load(f"toy.{mix}", root)
    return run.run_single(c, 2**31 + 3, 0.5, trace, CPU, t0=time.time(), workers=1, fault=fault)


def test_sound_run_is_correct(toy_root):
    res = _single(toy_root, trace=True)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {k: c["value"] for k, c in res["checks"].items()} == dict.fromkeys(res["checks"], 0)
    assert {"prover.blinds_ms", "graph.fetch_ms", "prover.tail_ms"} <= set(res["metrics"])
    assert res["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("fault", [None, "witness"])
def test_a_kind_and_route_added_as_files_run(toy_root, fault):
    """The toy chain kind proved by the toy eager route: correct, and not
    correct with the control's wrong witness."""
    c = cell_mod.load(add_toy_kind(toy_root), toy_root)
    res = run.run_single(c, 2**31 + 5, 0.5, False, CPU, t0=time.time(), workers=1, fault=fault)
    assert res["attempted"] >= 1 and res["checks"]["instances_differing"]["value"] == 0
    if fault is None:
        assert res["correct"]
    else:
        assert not res["correct"]
        assert res["checks"]["rows_unsatisfied"]["value"] >= 1
        assert res["checks"]["proofs_rejected"]["value"] >= 1


def test_cli_route_is_correct(toy_root):
    res = _single(toy_root, mix="toy-cli-zk")
    assert res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("fault, numbers", [("witness", ("rows_unsatisfied", "proofs_rejected")),
                                            ("answer", ("proofs_rejected",))])
def test_broken_timed_path_is_not_correct(toy_root, fault, numbers, monkeypatch):
    from otti_tpu_torch.spartan import zkfused

    # faults.plant replaces the program's host tail: restore it after the test
    monkeypatch.setattr(zkfused, "assemble_zk_proof", zkfused.assemble_zk_proof)
    res = _single(toy_root, fault=fault)
    assert not res["correct"]
    for n in numbers:
        assert res["checks"][n]["value"] >= 1
    assert res["checks"]["instances_differing"]["value"] == 0


def _ranks(root, fault, capsys, timeout=600):
    c = cell_mod.load("toy.toy-ranks2-zk", root)
    rc = ranks.launch(c, 2**32 + 5, 0.5, False, device="cpu", t0=time.time(), timeout=timeout,
                      fault=fault)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ranks_exchange_left_out_is_not_correct(toy_root, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc, res = _ranks(toy_root, "exchange", capsys)
    assert rc == 0 and not res["correct"]
    assert res["checks"]["proofs_rejected"]["value"] >= 1


def test_a_failing_rank_ends_the_run(toy_root, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    t0 = time.time()
    rc, res = _ranks(toy_root, "no such fault", capsys, timeout=120)
    assert rc == 1 and not res["correct"] and res["checks"]["ranks_failed"]["value"] >= 1
    assert time.time() - t0 < 120


def test_a_rank_that_loads_jax_gives_no_result(toy_root, tmp_path, capsys, monkeypatch):
    """Rank 1 alone holds a module named jax (planted at its start by a
    sitecustomize on its path): the run exits 3 and prints no result."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import os, sys, types\n"
        "if os.environ.get('RANK') == '1':\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    c = cell_mod.load("toy.toy-ranks2-zk", toy_root)
    rc = ranks.launch(c, 2**32 + 7, 0.5, False, device="cpu", t0=time.time(), timeout=600)
    assert rc == run.EXIT_JAX and capsys.readouterr().out == ""


def test_no_result_without_a_card(toy_root):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "proofbench.run", "--workload",
                        "lp-share1b.mono-zk", "--seed", "1", "--seconds", "1"],
                       cwd=toy_root, capture_output=True, text=True)
    assert p.returncode == run.EXIT_NO_CHIP and p.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card(card, tmp_path):
    p = subprocess.run([sys.executable, "-m", "proofbench.run", "--workload",
                        "lp-share1b.mono-zk", "--seed", str(2**31 + 99), "--seconds", "3"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
