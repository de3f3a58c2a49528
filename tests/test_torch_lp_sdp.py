"""LP and SDP certificates through the port, against the JAX package.

The smallest LP there is (one row, two columns: 219 constraints, padded to
2^8) is lowered by both packages and proved by both, transparent and in zero
knowledge with one blind seed: the proofs must be byte-equal and each
verifier must accept the other's.  The SDP ``sdpa.random_problem(2, 2,
seed=1)`` (2,110 constraints) is lowered by both (equal digest, witness and
inputs) and proved by the port alone, through its command line, as are the
LP flags (``--custom``, ``--delta``, ``--no-prove``, ``--resume``,
``--emit-zkif`` then ``--verify-zkif``).  The port runs on the CPU here.
Tolerance: exact equality.
"""

import json
import os

import pytest
import torch

import chip_smoke
from otti_tpu.codegen import lp_cert as j_lp_cert
from otti_tpu.io import mps as j_mps
from otti_tpu.oracle import lp_oracle as j_lp_oracle
from otti_tpu.spartan import nizk as JN
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import zknizk as JZ
from otti_tpu_torch import cli
from otti_tpu_torch.codegen import lp_cert as t_lp_cert
from otti_tpu_torch.io import mps as t_mps
from otti_tpu_torch.io import sdpa as t_sdpa
from otti_tpu_torch.oracle import lp_oracle as t_lp_oracle
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import zknizk as TZ

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

SEED = bytes(range(32))

LP_1X2 = """NAME LP1X2
ROWS
 N  COST
 L  R1
COLUMNS
    X1 COST -1.0 R1 1.0
    X2 COST -2.0 R1 1.0
RHS
    RHS R1 4.0
ENDATA
"""


@pytest.fixture(scope="module")
def lp_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("lp") / "lp1x2.mps"
    path.write_text(LP_1X2)
    return str(path)


@pytest.fixture(scope="module")
def lp(lp_file):
    """The LP lowered and proved by both packages."""
    pj, pt = j_mps.parse_mps(lp_file), t_mps.parse_mps(lp_file)
    xj, yj, _ = j_lp_oracle.solve(pj)
    xt, yt, opt = t_lp_oracle.solve(pt)
    assert opt == -8.0
    shape_j, vars_j, inputs_j = j_lp_cert.build(pj, xj, yj)
    shape_t, vars_t, inputs_t = t_lp_cert.build(pt, xt, yt)
    assert shape_t.digest() == shape_j.digest()
    assert (vars_t, inputs_t) == (vars_j, inputs_j)
    assert (shape_t.num_cons, shape_t.num_cons_padded) == (219, 256)
    dev_j, dev_t = shape_j.to_device(), shape_t.to_device("cpu")
    return dict(
        dev_j=dev_j, dev_t=dev_t, inputs=inputs_t,
        plain=(JN.prove(dev_j, vars_j, inputs_j), TN.prove(dev_t, vars_t, inputs_t)),
        zk=(JZ.prove(dev_j, vars_j, inputs_j, seed=SEED),
            TZ.prove(dev_t, vars_t, inputs_t, seed=SEED)),
    )


@pytest.mark.parametrize("mode", ["plain", "zk"])
def test_lp_proof_bytes_equal_jax(lp, mode):
    jax_proof, port_proof = lp[mode]
    assert TS.dumps(port_proof) == JS.dumps(jax_proof)
    assert port_proof.size_bytes() == jax_proof.size_bytes()


@pytest.mark.parametrize("mode", ["plain", "zk"])
def test_lp_each_verifier_accepts_the_others_proof(lp, mode):
    jax_proof, port_proof = lp[mode]
    j_mod, t_mod = (JN, TN) if mode == "plain" else (JZ, TZ)
    assert t_mod.verify(lp["dev_t"], lp["inputs"], port_proof)
    assert t_mod.verify(lp["dev_t"], lp["inputs"], TS.loads(JS.dumps(jax_proof)))
    assert j_mod.verify(lp["dev_j"], lp["inputs"], JS.loads(TS.dumps(port_proof)))
    forged = TS.loads(TS.dumps(port_proof))
    if mode == "plain":
        forged.claim_w = (forged.claim_w + 1) % TN.MOD
    else:
        forged.comm_vars[0] = forged.comm_vars[1]
    assert not t_mod.verify(lp["dev_t"], lp["inputs"], forged)


# ---- the command line -------------------------------------------------------

def _meta(out, kind, name):
    with open(out / kind / (name + ".meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("flags,mode", [([], "zk"), (["--transparent"], "plain")])
def test_cli_lp_custom(lp_file, tmp_path, capsys, flags, mode):
    out = tmp_path / "out"
    rc = cli.main(["--lp", "--custom", lp_file, "--device", "cpu", "--out", str(out)] + flags)
    text = capsys.readouterr().out
    assert rc == 0
    assert "Running LP custom data" in text and "Compiling lp1x2.mps" in text
    assert "  oracle optimum -8.0000" in text
    assert "Verification successful for lp1x2.mps" in text
    assert ("Proving lp1x2.mps (zk):" in text) == (mode == "zk")
    meta = _meta(out, "LP", "lp1x2.mps")
    assert meta["mode"] == mode and meta["verified"] and meta["device"] == "cpu"
    assert meta["num_cons"] == 219
    assert {"parse", "oracle", "lower", "to_device", "prove", "verify"} <= set(meta["timings"])
    proof = TS.load(str(out / "LP" / "lp1x2.mps.proof.json"))
    assert type(proof).__name__ == ("ZKNIZKProof" if mode == "zk" else "NIZKProof")
    assert meta["proof_bytes"] == proof.size_bytes()


def test_cli_lp_delta_is_part_of_the_statement(lp_file, tmp_path, capsys):
    """--delta with --no-prove: another tolerance lowers to another circuit."""
    counts = {}
    for delta in (None, "0.5"):
        flags = [] if delta is None else ["--delta", delta]
        rc = cli.main(["--lp", "--custom", lp_file, "--device", "cpu", "--no-prove",
                       "--out", str(tmp_path / "out")] + flags)
        text = capsys.readouterr().out
        assert rc == 0 and "Proving" not in text
        line = next(ln for ln in text.splitlines() if "lowered lp1x2.mps:" in ln)
        counts[delta] = int(line.split(":")[1].split()[0])
    assert counts[None] == 219 and counts["0.5"] != 219
    assert not (tmp_path / "out").exists()


def test_cli_lp_resume_skips_a_verified_instance(lp_file, tmp_path, capsys):
    args = ["--lp", "--custom", lp_file, "--device", "cpu", "--transparent",
            "--out", str(tmp_path / "out")]
    assert cli.main(args) == 0
    capsys.readouterr()
    assert cli.main(args + ["--resume"]) == 0
    text = capsys.readouterr().out
    assert "Skipping lp1x2.mps (already verified)" in text and "Proving" not in text


@pytest.mark.parametrize("n_files", [2, 3])
def test_cli_emit_zkif_then_verify_zkif(lp_file, tmp_path, capsys, n_files):
    out = tmp_path / "out"
    assert cli.main(["--lp", "--custom", lp_file, "--device", "cpu", "--transparent",
                     "--emit-zkif", "--out", str(out)]) == 0
    assert "emit_zkif" in _meta(out, "LP", "lp1x2.mps")["timings"]
    base = str(out / "LP" / "lp1x2.mps")
    triple = [base + ".zkif", base + ".inp.zkif", base + ".wit.zkif"]
    assert all(os.path.getsize(p) > 0 for p in triple)
    files = triple if n_files == 3 else [triple[0], triple[2]]
    capsys.readouterr()
    out2 = tmp_path / "out2"
    rc = cli.main(["--verify-zkif"] + files + ["--device", "cpu", "--out", str(out2)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "Importing " + triple[0] in text
    assert "Verification successful for lp1x2.mps.zkif" in text
    with open(out2 / "lp1x2.mps.zkif.meta.json") as f:
        meta = json.load(f)
    assert meta["mode"] == "zk" and meta["num_cons"] == 219 and meta["verified"]


def test_cli_verify_zkif_wants_two_or_three_files(lp_file, capsys):
    with pytest.raises(SystemExit) as err:
        cli.main(["--verify-zkif", lp_file, "--device", "cpu"])
    assert err.value.code == 2
    assert "--verify-zkif takes 2 or 3 files" in capsys.readouterr().err


@pytest.fixture()
def sdp_file(tmp_path):
    prob, _ = t_sdpa.random_problem(2, 2, seed=1)
    path = tmp_path / "r22.dat-s"
    chip_smoke.write_sdp_dats(str(path), prob)
    return str(path)


def test_cli_sdp_custom(sdp_file, tmp_path, capsys):
    out = tmp_path / "out"
    rc = cli.main(["--sdp", "--custom", sdp_file, "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "Running SDP custom data" in text and "Making certificate for r22.dat-s" in text
    assert "Verification successful for r22.dat-s" in text
    meta = _meta(out, "SDP", "r22.dat-s")
    assert meta["mode"] == "zk" and meta["verified"] and meta["device"] == "cpu"
    assert meta["num_cons"] == 2110
    proof = TS.load(str(out / "SDP" / "r22.dat-s.proof.json"))
    assert type(proof).__name__ == "ZKNIZKProof"
    # epsilon is a parameter of the statement, as delta is for an LP
    capsys.readouterr()
    assert cli.main(["--sdp", "--custom", sdp_file, "--device", "cpu", "--no-prove",
                     "--epsilon", "0.5", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "lowered r22.dat-s:" in text and "lowered r22.dat-s: 2110 " not in text


def test_cli_sdp_refuses_a_file_that_is_no_dat_s(lp_file, tmp_path, capsys):
    rc = cli.main(["--sdp", "--custom", lp_file, "--device", "cpu", "--out", str(tmp_path / "o")])
    text = capsys.readouterr().out
    assert rc == 0  # as the JAX CLI: reported and left out
    assert "ERROR: lp1x2.mps is not a dat-s file" in text and "Proving" not in text


def test_cli_failing_instance_gives_exit_code_1(tmp_path, capsys):
    """An LP whose optimum sits on an upper bound: the oracle refuses it (the
    row-only certificate has no bound duals), the run goes on and fails."""
    path = tmp_path / "bounded.mps"
    path.write_text(LP_1X2.replace("ENDATA", "BOUNDS\n UP BND X2 1.0\nENDATA"))
    rc = cli.main(["--lp", "--custom", str(path), "--device", "cpu", "--out", str(tmp_path / "o")])
    text = capsys.readouterr().out
    assert rc == 1
    assert "INSTANCE FAILED bounded.mps: RuntimeError" in text and "duality gap" in text


@pytest.mark.parametrize("flags,needle", [
    (["--lp"], "this suite is not in the repository"),
    (["--sdp", "--full"], "this suite is not in the repository"),
    (["--lp", "--config", "x.json"], "--config is for --sgd"),
    (["--sgd", "--custom", "x.mps"], "--sgd has no --custom mode"),
    (["--lp", "--custom", "x.mps", "--num-hosts", "2"],
     "--coordinator, --num-hosts and --host-id go together"),
    (["--sdp", "--custom", "x.dat-s", "--batch", "--snark"], "mutually exclusive"),
])
def test_cli_lp_sdp_refusals(tmp_path, capsys, flags, needle):
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as err:
        cli.main(flags + ["--device", "cpu", "--out", str(out),
                          "--datasets", str(tmp_path / "no_such_datasets")])
    assert err.value.code == 2
    assert needle in capsys.readouterr().err
    assert not out.exists()


def test_cli_cpu_flag_is_device_cpu(lp_file, tmp_path):
    """The JAX CLI's --cpu: the same run as --device cpu (transparent, so
    the two proofs are byte-equal)."""
    outs = [tmp_path / "cpu", tmp_path / "device"]
    for flag, out in zip((["--cpu"], ["--device", "cpu"]), outs):
        assert cli.main(["--lp", "--custom", lp_file, "--transparent", "--out", str(out)]
                        + flag) == 0
        assert _meta(out, "LP", "lp1x2.mps")["device"] == "cpu"
    a, b = ((out / "LP" / "lp1x2.mps.proof.json").read_text() for out in outs)
    assert a == b


@pytest.fixture(scope="module")
def zkif_triple(lp_file, tmp_path_factory):
    """The LP as a zkinterface triple (circuit, inputs, witness), written by
    the port's exporter."""
    from otti_tpu_torch.io import zkif as t_zkif

    prob = t_mps.parse_mps(lp_file)
    x, y, _ = t_lp_oracle.solve(prob)
    base = str(tmp_path_factory.mktemp("zkif") / "lp1x2")
    t_zkif.export_r1cs(*t_lp_cert.build(prob, x, y), base)
    return [base + ".zkif", base + ".inp.zkif", base + ".wit.zkif"]


def test_cli_verify_zkif_ignores_wire_as_the_jax_cli(zkif_triple, tmp_path, monkeypatch):
    """--verify-zkif proves with the native labels whatever --wire says, in
    both CLIs: one blind seed (os.urandom patched) and the classic prover
    give the same proof bytes and meta mode."""
    from otti_tpu import cli as jcli

    monkeypatch.setenv("OTTI_CLASSIC", "1")
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    args = ["--verify-zkif"] + zkif_triple + ["--wire", "spartan"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "torch")]) == 0
    metas, proofs = [], []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "lp1x2.zkif.meta.json") as f:
            metas.append(json.load(f))
        proofs.append((tmp_path / side / "lp1x2.zkif.proof.json").read_text())
    assert metas[0]["mode"] == metas[1]["mode"] == "zk-classic"
    assert metas[0]["verified"] and metas[1]["verified"]
    assert proofs[0] == proofs[1]


def test_run_lp_batch_proves_a_shape_class(lp_file, tmp_path, capsys):
    """Two LP files of one padded shape class: one zk batch, each proof
    verified and byte-distinct (fresh blinds), meta mode batched-zk."""
    other = tmp_path / "lp1x2b.mps"
    other.write_text(LP_1X2)
    out = tmp_path / "out"
    assert cli.run_lp([lp_file, str(other)], str(out), batch=True, device="cpu")
    text = capsys.readouterr().out
    assert "Batched proving 2 instance(s) (zk) (shape class 256x" in text
    proofs = []
    for name in ("lp1x2.mps", "lp1x2b.mps"):
        assert "Verification successful for %s (batched)" % name in text
        meta = _meta(out, "LP", name)
        assert meta["mode"] == "batched-zk" and meta["verified"] and meta["batch"] == 2
        assert meta["num_cons"] == 219
        proofs.append(TS.load(str(out / "LP" / (name + ".proof.json"))))
    assert TS.dumps(proofs[0]) != TS.dumps(proofs[1])


def test_run_sdp_batch_transparent(sdp_file, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.run_sdp([sdp_file], str(out), zk=False, batch=True, device="cpu")
    assert "Verification successful for r22.dat-s (batched)" in capsys.readouterr().out
    meta = _meta(out, "SDP", "r22.dat-s")
    assert meta["mode"] == "batched" and meta["verified"] and meta["num_cons"] == 2110
    assert type(TS.load(str(out / "SDP" / "r22.dat-s.proof.json"))).__name__ == "NIZKProof"
