"""The port's zero-knowledge NIZK against otti_tpu.spartan.zknizk.

With inputs made from a numpy seed and one fixed 32-byte blind seed, the
blinded row commitments, both zk sumchecks and the whole proof must equal
the JAX package's byte for byte, under both wire profiles; each verifier
must accept the other's proof; tampered proofs and changed inputs must be
rejected; two seeds must give two proofs.  The port runs on the CPU here
(plain versions of its kernels).  Tolerance: exact equality, this is modular
arithmetic.  The toy R1CS and the 8x3 SGD instance share one padded shape
(64 constraints, 64 variables), and the sumcheck cases use its table sizes,
so that the JAX side compiles one set of kernels.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from otti_tpu.codegen import sgd_cert as j_sgd_cert
from otti_tpu.field.fields import SCALAR, ints_to_limbs
from otti_tpu.oracle import sgd_oracle
from otti_tpu.spartan import commitments as JC
from otti_tpu.spartan import pedersen_host as JP
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import zknizk as JZ
from otti_tpu.spartan import zksumcheck as JZS
from otti_tpu.spartan.wire import PROFILES as J_PROFILES
from otti_tpu.transcript.merlin import Transcript as JTranscript
from otti_tpu_torch import cli, convert
from otti_tpu_torch.codegen import sgd_cert as t_sgd_cert
from otti_tpu_torch.curve import edwards as E
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.msm import pippenger as TPip
from otti_tpu_torch.spartan import commitments as TC
from otti_tpu_torch.spartan import pedersen_host as TP
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import hybrid as THY
from otti_tpu_torch.spartan import zkfused as TZF
from otti_tpu_torch.spartan import zknizk as TZ
from otti_tpu_torch.spartan import zksumcheck as TZS
from otti_tpu_torch.spartan.wire import PROFILES as T_PROFILES
from otti_tpu_torch.transcript.merlin import Transcript as TTranscript

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = SCALAR.modulus
SEED = bytes(range(32))
LABEL = b"port-test gens"
WIRES = ["otti", "spartan"]


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % M for _ in range(n)]


# ---- blinded row commitments ---------------------------------------------

@pytest.mark.parametrize("blinded", [True, False])
def test_commit_rows_with_blinds_matches_jax(blinded):
    """The 8 x 8 grid and the label of the instances below (one set of
    tables for the file): with the blind column a row sums (8 + 1) * 32
    points, which is no power of two.  All-zero blinds commit without H."""
    rows, cols, LABEL = 8, 8, TZ.GENS_LABEL
    vals = _ints(rows * cols, 11)
    vals[:3] = [0, 1, M - 1]
    blinds = _ints(rows, 12) if blinded else [0] * rows
    W = ints_to_limbs(vals).reshape(rows, cols, -1)
    want = JC.encode_points(JC.commit_rows(jnp.asarray(W), blinds, LABEL))
    got = TC.encode_points(TC.commit_rows(convert.limbs(W), blinds, LABEL))
    assert got == want
    if blinded:
        plain = TC.encode_points(TC.commit_rows(convert.limbs(W), [0] * rows, LABEL))
        assert all(a != b for a, b in zip(got, plain))
        # Pedersen on the host: sum_c W[r, c] G_c + blind_r H
        gens = TP.Gens(cols, LABEL)
        host = [TP.commit_vec(vals[r * cols:(r + 1) * cols], blinds[r], gens).ristretto_encode()
                for r in range(rows)]
        assert got == host


def test_blinded_comb_table_is_keyed_apart():
    """H is the last generator of a table built with the blind, and such a
    table is never the cached unblinded one."""
    plain = TPip.fixed_base_tables(2, LABEL, False)["p"]
    blind = TPip.fixed_base_tables(2, LABEL, True)["p"]
    per_gen = TPip.N_WIN * TPip.N_DIGITS
    assert plain.shape[0] == 2 * per_gen and blind.shape[0] == 3 * per_gen
    assert torch.equal(blind[: 2 * per_gen], plain)
    h = TC.gen_points_host(2, LABEL)[1]
    assert torch.equal(blind[2 * per_gen:], TPip.build_comb_table([h], "cpu"))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 12])
def test_sum_points_at_any_width(n):
    """The add tree over a width that is no power of two (what the blind
    column gives it) sums every point once, along an inner axis."""
    gens = TP.Gens(2 * n, LABEL).G
    batch = E.stack([E.stack([E.from_ref(q) for q in gens[r * n:(r + 1) * n]]) for r in range(2)])
    got = E.to_refs(E.sum_points(batch, axis=1))
    for r in range(2):
        total = gens[r * n]
        for q in gens[r * n + 1:(r + 1) * n]:
            total = total + q
        assert got[r] == total


# ---- the zk sumcheck ------------------------------------------------------

@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("degree,n", [(3, 64), (2, 128)])
def test_prove_zk_matches_jax(degree, n, wire):
    k = 4 if degree == 3 else 2
    vals = [_ints(n, 20 + degree * 10 + i) for i in range(k)]
    claim, claim_blind = _ints(2, 5)
    outs = []
    for mod, ped, transcript, profiles, tables in (
        (JZS, JP, JTranscript, J_PROFILES,
         tuple(jnp.asarray(ints_to_limbs(v)) for v in vals)),
        (TZS, TP, TTranscript, T_PROFILES,
         tuple(F.from_ints(SCALAR, v) for v in vals)),
    ):
        t = transcript(b"zk sumcheck test")
        proof, rs, finals, e, be = mod.prove_zk(
            degree, claim, claim_blind, tables, t, b"sc", ped.Gens(4, LABEL),
            ped.BlindSource(SEED), wire=profiles[wire])
        dots = [dataclasses.astuple(d) for d in proof.dot_proofs]
        outs.append((proof.comm_polys, proof.comm_evals, dots, rs, tuple(finals), e, be,
                     t.challenge_scalar(b"after")))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == n.bit_length() - 1


@pytest.mark.parametrize("degree", [3, 2])
def test_verify_zk_accepts_and_rejects(degree):
    """The port's verifier on the port's sumcheck proof of a true claim."""
    n = 16
    k = 4 if degree == 3 else 2
    vals = [_ints(n, 40 + degree * 10 + i) for i in range(k)]
    if degree == 3:
        claim = sum(a * (b * c - d) for a, b, c, d in zip(*vals)) % M
    else:
        claim = sum(a * b for a, b in zip(*vals)) % M
    gens = TP.Gens(4, LABEL)
    blind = 77
    proof, rs, finals, e, be = TZS.prove_zk(
        degree, claim, blind, tuple(F.from_ints(SCALAR, v) for v in vals),
        TTranscript(b"zk sumcheck test"), b"sc", gens, TP.BlindSource(SEED))
    C_claim = TP.commit(claim, blind, gens)
    rs_v, C_final = TZS.verify_zk(degree, proof, C_claim, 4, TTranscript(b"zk sumcheck test"),
                                  b"sc", gens)
    assert rs_v == rs
    assert C_final.ristretto_encode() == TP.commit(e, be, gens).ristretto_encode()
    if degree == 3:
        assert finals[0] * (finals[1] * finals[2] - finals[3]) % M == e
    else:
        assert finals[0] * finals[1] % M == e
    with pytest.raises(ValueError):
        TZS.verify_zk(degree, proof, TP.commit(claim + 1, blind, gens), 4,
                      TTranscript(b"zk sumcheck test"), b"sc", gens)
    with pytest.raises(ValueError):
        TZS.verify_zk(degree, proof, C_claim, 3, TTranscript(b"zk sumcheck test"), b"sc", gens)


# ---- the whole proof ------------------------------------------------------

def _sgd_small():
    """The 8x3 instance of tests/test_codegen_sgd.py::test_sgd_nizk_end_to_end_small."""
    rng = np.random.default_rng(0)
    X = rng.integers(-5, 6, size=(8, 3))
    w_true = np.array([2, -1, 3])
    y = np.where(X @ w_true >= 0, 1, -1)
    for i in range(len(y)):
        while y[i] * (X[i] @ w_true) < 1:
            X[i] += y[i] * np.sign(w_true)
    return X, y, sgd_oracle.solve(X, y)


def _instances():
    shape_j, zvars = graft._toy_r1cs(n_cons=64, n_vars=64)
    shape_t, zvars_t = TR.random_satisfiable(64, 64)
    assert zvars_t == zvars
    yield "toy", shape_j, shape_t, zvars, []
    X, y, w = _sgd_small()
    shape_j, vars_j, inputs_j = j_sgd_cert.build(X, y, w)
    shape_t, vars_t, inputs_t = t_sgd_cert.build(X, y, w)
    assert (vars_t, inputs_t) == (vars_j, inputs_j)
    yield "sgd8x3", shape_j, shape_t, vars_j, inputs_j


@pytest.fixture(scope="module")
def proved():
    out = {}
    for name, shape_j, shape_t, vars_, inputs in _instances():
        dev_j = shape_j.to_device()
        dev_t = shape_t.to_device("cpu")
        out[name] = dict(dev_j=dev_j, dev_t=dev_t, vars=vars_, inputs=inputs)
        for wire in WIRES:
            out[name][wire] = dict(
                jax=JZ.prove(dev_j, vars_, inputs, seed=SEED, wire=wire),
                port=TZ.prove(dev_t, vars_, inputs, seed=SEED, wire=wire),
            )
    return out


CASES = [(name, wire) for name in ("toy", "sgd8x3") for wire in WIRES]


@pytest.mark.parametrize("name,wire", CASES)
def test_zk_proof_bytes_equal_jax(proved, name, wire):
    p = proved[name][wire]
    assert TS.dumps(p["port"]) == JS.dumps(p["jax"])
    assert p["port"].size_bytes() == p["jax"].size_bytes()


@pytest.mark.parametrize("name,wire", CASES)
def test_each_zk_verifier_accepts_the_others_proof(proved, name, wire):
    inst, p = proved[name], proved[name][wire]
    other = "spartan" if wire == "otti" else "otti"
    assert TZ.verify(inst["dev_t"], inst["inputs"], p["port"], wire=wire)
    assert not TZ.verify(inst["dev_t"], inst["inputs"], p["port"], wire=other)
    assert JZ.verify(inst["dev_j"], inst["inputs"], JS.loads(TS.dumps(p["port"])), wire=wire)
    assert TZ.verify(inst["dev_t"], inst["inputs"], TS.loads(JS.dumps(p["jax"])), wire=wire)
    assert TS.loads(TS.dumps(p["port"])) == p["port"]


def _tampered(proof, which):
    """The cases of tests/test_zknizk.py::test_zk_soundness_tampered."""
    if which == "round_commitment":
        polys = [proof.sc1.comm_polys[-1]] + proof.sc1.comm_polys[1:]
        return dataclasses.replace(proof, sc1=dataclasses.replace(proof.sc1, comm_polys=polys))
    if which == "witness_eval_commitment":
        return dataclasses.replace(proof, comm_w=proof.comm_vars[0])
    if which == "bullet_response":
        return dataclasses.replace(
            proof, bullet=dataclasses.replace(proof.bullet, z1=(proof.bullet.z1 + 1) % M))
    if which == "dual_base_tie":
        return dataclasses.replace(
            proof, base_eq=dataclasses.replace(proof.base_eq, z=(proof.base_eq.z + 1) % M))
    if which == "product_proof":
        z = proof.proof_ab.z
        return dataclasses.replace(
            proof, proof_ab=dataclasses.replace(proof.proof_ab, z=((z[0] + 1) % M,) + tuple(z[1:])))
    if which == "final_equality":
        return dataclasses.replace(
            proof, eq2=dataclasses.replace(proof.eq2, z=(proof.eq2.z + 1) % M))
    if which == "dropped_row":
        return dataclasses.replace(proof, comm_vars=proof.comm_vars[:-1])
    raise KeyError(which)


@pytest.mark.parametrize("which", ["round_commitment", "witness_eval_commitment",
                                   "bullet_response", "dual_base_tie", "product_proof",
                                   "final_equality", "dropped_row"])
def test_tampered_zk_proof_is_rejected(proved, which):
    inst = proved["sgd8x3"]
    bad = _tampered(inst["otti"]["port"], which)
    assert not TZ.verify(inst["dev_t"], inst["inputs"], bad)


@pytest.mark.parametrize("name,prover", [("toy", "zkfused"), ("sgd8x3", "hybrid")])
def test_device_fs_zk_provers_equal_jax(proved, name, prover):
    """The device-transcript zk provers (the CLI's default below and above
    the 2^12 crossover) against the JAX package's zknizk.prove, one seed;
    each package's verifier accepts the other's proof."""
    inst = proved[name]
    prove = TZF.prove if prover == "zkfused" else THY.prove_zk
    proof = prove(inst["dev_t"], inst["vars"], inst["inputs"], seed=SEED)
    assert TS.dumps(proof) == JS.dumps(inst["otti"]["jax"])
    assert JZ.verify(inst["dev_j"], inst["inputs"], JS.loads(TS.dumps(proof)))
    assert TZ.verify(inst["dev_t"], inst["inputs"], proof)


def test_changed_public_input_is_rejected(proved):
    inst = proved["sgd8x3"]
    bad = [(inst["inputs"][0] + 1) % M] + inst["inputs"][1:]
    assert not TZ.verify(inst["dev_t"], bad, inst["otti"]["port"])
    assert not JZ.verify(inst["dev_j"], bad, JS.loads(TS.dumps(inst["otti"]["port"])))


def test_two_seeds_give_two_proofs(proved):
    inst = proved["toy"]
    p1 = inst["otti"]["port"]
    p2 = TZ.prove(inst["dev_t"], inst["vars"], inst["inputs"], seed=b"\x05" * 32)
    p3 = TZ.prove(inst["dev_t"], inst["vars"], inst["inputs"])  # fresh randomness
    assert TZ.verify(inst["dev_t"], inst["inputs"], p2)
    assert TZ.verify(inst["dev_t"], inst["inputs"], p3)
    assert all(a != b for a, b in zip(p1.comm_vars, p2.comm_vars))
    assert all(a != b for a, b in zip(p2.comm_vars, p3.comm_vars))
    assert TS.dumps(TZ.prove(inst["dev_t"], inst["vars"], inst["inputs"], seed=SEED)) \
        == TS.dumps(p1)


def test_zk_port_runs_without_jax():
    """In a fresh interpreter (this one imported jax through conftest)."""
    code = (
        "import sys\n"
        "from otti_tpu_torch.spartan import r1cs, serial, zknizk\n"
        "shape, zvars = r1cs.random_satisfiable(64, 64)\n"
        "dev = shape.to_device('cpu')\n"
        "proof = zknizk.prove(dev, zvars, [], seed=b'\\x07' * 32)\n"
        "assert zknizk.verify(dev, [], proof)\n"
        "assert serial.loads(serial.dumps(proof)) == proof\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "strays = [m for m in sys.modules if m == 'otti_tpu' or m.startswith('otti_tpu.')]\n"
        "assert not strays, strays\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")


# ---- the command line -----------------------------------------------------

@pytest.fixture()
def tiny_config(tmp_path, monkeypatch):
    """The 8x3 data set as a cached PMLB file, and a config that names it."""
    X, y, _ = _sgd_small()
    root = tmp_path / "cache" / "tiny8x3"
    root.mkdir(parents=True)
    with open(root / "tiny8x3.tsv", "w") as f:
        f.write("a\tb\tc\ttarget\n")
        for row, label in zip(X, y):
            f.write("\t".join(str(int(v)) for v in row) + f"\t{1 if label == 1 else 0}\n")
    monkeypatch.setenv("PMLB_CACHE_DIR", str(tmp_path / "cache"))
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(
        {"tiny8x3": {"classes": [1, 0], "seed": 0, "eta0": 0.1, "maxiter": 1000, "tol": 1e-4}}))
    return str(cfg), tmp_path / "out"


def _meta(out):
    with open(out / "SGD" / "tiny8x3.meta.json") as f:
        return json.load(f)


@pytest.mark.parametrize("flags,mode", [
    ([], "zk"),
    (["--zk"], "zk"),
    (["--transparent"], "plain"),
    (["--wire", "spartan"], "zk-wire-spartan"),
    (["--transparent", "--wire", "spartan"], "plain-wire-spartan"),
])
def test_cli_modes(tiny_config, capsys, flags, mode):
    cfg, out = tiny_config
    rc = cli.main(["--sgd", "--config", cfg, "--device", "cpu", "--out", str(out)] + flags)
    text = capsys.readouterr().out
    assert rc == 0
    assert "Verification successful for tiny8x3" in text
    zk = mode.startswith("zk")
    assert ("Proving tiny8x3 (zk):" in text) == zk
    meta = _meta(out)
    assert meta["mode"] == mode and meta["verified"] and meta["device"] == "cpu"
    assert meta["data_source"] == "pmlb_cache"
    proof = TS.load(str(out / "SGD" / "tiny8x3.proof.json"))
    assert type(proof).__name__ == ("ZKNIZKProof" if zk else "NIZKProof")
    assert meta["proof_bytes"] == proof.size_bytes()
    # the prover the CLI picks at this size (64 x 64, under the 2^12 crossover):
    # zkfused.prove / fused.prove, and zknizk.prove for the spartan profile's labels
    stages = {
        "zk": {"zkfused_prove_s", "host_decode_s", "host_sigma_s", "host_serialize_s"},
        "plain": {"fused_prove_s"},
        "plain-wire-spartan": {"fused_prove_s"},
        "zk-wire-spartan": {"commit_s", "matvec_s", "sumcheck1_s", "sigma_s", "sumcheck2_s",
                            "opening_s"},
    }[mode]
    assert stages <= set(meta["prover_metrics"])


def test_cli_resume_skips_a_verified_instance(tiny_config, capsys):
    cfg, out = tiny_config
    args = ["--sgd", "--config", cfg, "--device", "cpu", "--out", str(out)]
    assert cli.main(args) == 0
    first = (out / "SGD" / "tiny8x3.proof.json").read_text()
    capsys.readouterr()
    assert cli.main(args + ["--resume"]) == 0
    text = capsys.readouterr().out
    assert "Skipping tiny8x3 (already verified)" in text and "Proving" not in text
    assert (out / "SGD" / "tiny8x3.proof.json").read_text() == first
    assert cli.main(args) == 0  # without --resume it proves again, with new blinds
    assert (out / "SGD" / "tiny8x3.proof.json").read_text() != first


@pytest.mark.parametrize("flags,needle", [
    (["--zk", "--transparent"], "mutually exclusive"),
    (["--lp"], "--config is for --sgd"),
    (["--sdp"], "--config is for --sgd"),
    (["--snark", "--zk"], "--zk and --snark are mutually exclusive"),
    (["--coordinator", "127.0.0.1:1", "--num-hosts", "2", "--host-id", "2"],
     "--host-id 2 is not a rank of --num-hosts 2"),
    (["--batch", "--snark"], "--batch and --snark are mutually exclusive"),
    (["--wire", "other"], "invalid choice"),
])
def test_cli_refusals(tiny_config, capsys, flags, needle):
    cfg, out = tiny_config
    with pytest.raises(SystemExit) as err:
        cli.main(["--sgd", "--config", cfg, "--device", "cpu", "--out", str(out)] + flags)
    assert err.value.code == 2
    assert needle in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("zk,mode", [(True, "batched-zk"), (False, "batched")])
def test_run_sgd_batch_proves_and_verifies(tiny_config, capsys, zk, mode):
    """--batch as a run function: the instance is proved by spartan/batched.py
    (here a batch of one) and verified; the meta says so."""
    cfg, out = tiny_config
    assert cli.run_sgd(cfg, str(out), zk=zk, batch=True, device="cpu")
    text = capsys.readouterr().out
    assert "Batched proving 1 instance(s)" in text
    assert "Verification successful for tiny8x3 (batched)" in text
    meta = _meta(out)
    assert meta["mode"] == mode and meta["verified"] and meta["batch"] == 1
    assert meta["device"] == "cpu" and meta["timings"]["prove"] > 0
    proof = TS.load(str(out / "SGD" / "tiny8x3.proof.json"))
    assert type(proof).__name__ == ("ZKNIZKProof" if zk else "NIZKProof")


def test_cli_snark_mode_on_the_sgd_config(tiny_config, capsys):
    """--snark opts out of zero knowledge, as --transparent does."""
    cfg, out = tiny_config
    rc = cli.main(["--sgd", "--config", cfg, "--device", "cpu", "--snark", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "Proving tiny8x3 (snark):" in text and "Verification successful for tiny8x3" in text
    meta = _meta(out)
    assert meta["mode"] == "snark" and meta["verified"] and "snark_setup" in meta["timings"]
    assert type(TS.load(str(out / "SGD" / "tiny8x3.proof.json"))).__name__ == "SNARKProof"


@pytest.mark.cuda
def test_zk_prove_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, zvars = TR.random_satisfiable(64, 64)
    outs = [TS.dumps(TZ.prove(shape.to_device(d), zvars, [], seed=SEED)) for d in ("cuda", "cpu")]
    assert outs[0] == outs[1]
