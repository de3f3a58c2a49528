"""SNARK mode through the port's command line.

``--snark`` on an instance imported from a zkinterface triple (the toy
instance of tests/test_nizk.py, exported by the port) and its flag
conflicts.  The port runs on the CPU here.  (``--snark --sgd --config`` is
driven in tests/test_torch_zknizk.py, beside the other modes of that path;
the SNARK modules in an interpreter without jax are in
tests/test_torch_snark_no_jax.py.)
"""

import json

import pytest
import torch

from otti_tpu_torch import cli
from otti_tpu_torch.io import zkif as t_zkif
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS
from tests.test_nizk import toy_instance

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each


def _port_shape(shape_j):
    return TR.R1CSShape(shape_j.num_cons, shape_j.num_vars, shape_j.num_inputs,
                        list(shape_j.A), list(shape_j.B), list(shape_j.C))


@pytest.fixture()
def toy_zkif(tmp_path):
    shape_j, vars_, ios = toy_instance()
    base = str(tmp_path / "toy")
    t_zkif.export_r1cs(_port_shape(shape_j), vars_, ios, base)
    return base, tmp_path / "out"


def test_cli_snark_on_an_imported_instance(toy_zkif, capsys):
    base, out = toy_zkif
    rc = cli.main(["--verify-zkif", base + ".zkif", base + ".inp.zkif", base + ".wit.zkif",
                   "--snark", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "Proving toy.zkif (snark):" in text and "Verification successful for toy.zkif" in text
    with open(out / "toy.zkif.meta.json") as f:
        meta = json.load(f)
    assert meta["mode"] == "snark" and meta["verified"] and meta["device"] == "cpu"
    assert "snark_setup" in meta["timings"] and "prove" in meta["timings"]
    assert {"commit_s", "sumcheck1_s", "spark_entry_s", "spark_tables_s"} <= set(
        meta["prover_metrics"])
    proof = TS.load(str(out / "toy.zkif.proof.json"))
    assert type(proof).__name__ == "SNARKProof" and meta["proof_bytes"] == proof.size_bytes()


@pytest.mark.parametrize("flags,needle", [
    (["--zk", "--snark"], "--zk and --snark are mutually exclusive"),
    (["--batch", "--snark"], "--batch and --snark are mutually exclusive"),
])
def test_cli_snark_flag_conflicts(toy_zkif, capsys, flags, needle):
    base, out = toy_zkif
    with pytest.raises(SystemExit) as err:
        cli.main(["--verify-zkif", base + ".zkif", base + ".wit.zkif", "--device", "cpu",
                  "--out", str(out)] + flags)
    assert err.value.code == 2
    assert needle in capsys.readouterr().err
    assert not out.exists()
