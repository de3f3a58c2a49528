"""The port's device-transcript provers (spartan/fused.py, zkfused.py,
hybrid.py) against its host-transcript ones, and the CLI's choice.

On the instances of the JAX package's own tests of these provers (the toy
R1CS of tests/test_nizk.py, ``_random_r1cs(16, 8, 3)`` of
tests/test_fused.py with a two-row Hyrax grid), ``fused.prove`` and
``hybrid.prove`` must give the bytes of the port's ``nizk.prove``, and
``hybrid.prove_zk`` (toy) and ``zkfused.prove`` (two rows) those of
``zknizk.prove`` for one blind seed; the port's nizk/zknizk are held against the JAX package's in
tests/test_torch_nizk.py and tests/test_torch_zknizk.py, which also hold
the device-transcript provers against the JAX package's proofs directly at
their 64 x 64 shape.  The JAX package's fused/zkfused/hybrid provers are
not called here: their XLA compile takes minutes on the CPU.  The kernel-2
round with a challenge tensor must equal the int form; the CLI's prover
choice must be the JAX CLI's.  Tolerance: exact equality.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from otti_tpu import cli as j_cli
from otti_tpu.field.fields import SCALAR, ints_to_limbs
from otti_tpu_torch import cli
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.spartan import fused, hybrid, nizk, r1cs, serial, zkfused, zknizk
from otti_tpu_torch.spartan import sumcheck_kernels as SK
from otti_tpu_torch.transcript.device import POST_CHALLENGE
from otti_tpu_torch.transcript.merlin import Transcript
from tests.test_fused import _random_r1cs
from tests.test_nizk import toy_instance

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = SCALAR.modulus
SEED = b"\x31" * 32


def _port_shape(shape_j):
    s = r1cs.R1CSShape(shape_j.num_cons, shape_j.num_vars, shape_j.num_inputs,
                       list(shape_j.A), list(shape_j.B), list(shape_j.C))
    assert s.digest() == shape_j.digest()
    return s


@pytest.fixture(scope="module")
def instances():
    out = {}
    shape, vars_, ios = toy_instance()
    out["toy"] = (_port_shape(shape).to_device("cpu"), vars_, ios)
    shape, vars_, ios = _random_r1cs(16, 8, 3, seed=16)
    dev = _port_shape(shape).to_device("cpu")
    assert nizk._hyrax_dims(dev.num_vars)[0] > 0  # more than one Hyrax row
    out["rows2"] = (dev, vars_, ios)
    return out


@pytest.mark.parametrize("degree", [3, 2])
def test_round_with_tensor_challenge_equals_int(degree):
    """The plain round (kernel 2's reference) binds a [22] limb tensor as
    it binds the int of the same value, down to the final bind."""
    rng = np.random.default_rng(degree)
    n, k = 16, (4 if degree == 3 else 2)
    vals = [[int.from_bytes(rng.bytes(32), "little") % M for _ in range(n)] for _ in range(k)]
    rs = [int.from_bytes(rng.bytes(32), "little") % M for _ in range(4)]
    by_int = [F.from_ints(SCALAR, v) for v in vals]
    by_tensor = [t.clone() for t in by_int]
    out_i = [SK.sumcheck_round(by_int, degree)]
    out_t = [SK.sumcheck_round(by_tensor, degree)]
    active = n
    for r in rs:
        out_i.append(SK.sumcheck_round(by_int, degree, r, active // 2))
        r_t = torch.from_numpy(ints_to_limbs([r]).astype(np.int32).reshape(22))
        out_t.append(SK.sumcheck_round(by_tensor, degree, r_t, active // 2))
        active //= 2
    assert out_i[-1] is None and out_t[-1] is None
    assert all(torch.equal(a, b) for a, b in zip(out_i[:-1], out_t[:-1]))
    assert all(torch.equal(a[:1], b[:1]) for a, b in zip(by_int, by_tensor))
    with pytest.raises(ValueError):
        SK.sumcheck_round(by_int, degree, torch.zeros(21, dtype=torch.int32), 1)


@pytest.mark.parametrize("name", ["toy", "rows2"])
def test_plain_device_fs_provers_equal_nizk(instances, name):
    dev, vars_, ios = instances[name]
    want = serial.dumps(nizk.prove(dev, vars_, ios))
    for prove in (fused.prove, hybrid.prove):
        proof = prove(dev, vars_, ios)
        assert serial.dumps(proof) == want, prove.__module__
        assert nizk.verify(dev, ios, proof)


# one zk prover an instance here (a CPU zk proof of the device-transcript
# provers takes seconds); tests/test_torch_zknizk.py holds zkfused on its toy
# and hybrid on its SGD instance against the JAX package's zknizk
ZK_CASES = [("toy", "hybrid"), ("rows2", "zkfused")]


@pytest.fixture(scope="module")
def zk_proved(instances):
    out = {}
    for name, prover in ZK_CASES:
        dev, vars_, ios = instances[name]
        prove = zkfused.prove if prover == "zkfused" else hybrid.prove_zk
        out[name] = {"classic": zknizk.prove(dev, vars_, ios, seed=SEED),
                     prover: prove(dev, vars_, ios, seed=SEED)}
    return out


@pytest.mark.parametrize("name,prover", ZK_CASES)
def test_zk_device_fs_provers_equal_zknizk(instances, zk_proved, name, prover):
    dev, _, ios = instances[name]
    proof = zk_proved[name][prover]
    assert serial.dumps(proof) == serial.dumps(zk_proved[name]["classic"])
    assert zknizk.verify(dev, ios, proof)
    assert serial.loads(serial.dumps(proof)) == proof


@pytest.mark.parametrize("name,prover", ZK_CASES)
def test_tampered_device_fs_zk_proof_is_rejected(instances, zk_proved, name, prover):
    dev, _, ios = instances[name]
    proof = zk_proved[name][prover]
    bad = dataclasses.replace(proof, bullet=dataclasses.replace(
        proof.bullet, z1=(proof.bullet.z1 + 1) % M))
    assert not zknizk.verify(dev, ios, bad)
    assert not zknizk.verify(dev, [(ios[0] + 1) % M] + ios[1:], proof)


def test_handoff_wants_the_post_challenge_offsets():
    t = Transcript(b"handoff")
    t.append_message(b"m", b"x" * 10)
    with pytest.raises(AssertionError, match="post-challenge"):
        hybrid._check_handoff([t], "cpu")
    t.challenge_scalar(b"c")
    assert hybrid._check_handoff([t], "cpu").strobe.offsets == POST_CHALLENGE


# ---- the command line -----------------------------------------------------

ENVS = [{}, {"OTTI_FUSED": "1"}, {"OTTI_NO_FUSED": "1"}, {"OTTI_FUSED_MAX_VARS": "64"},
        {"OTTI_FUSED_MAX_VARS": "32768"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(e) or "default")
def test_choose_fused_matches_the_jax_cli(monkeypatch, env):
    for k in ("OTTI_FUSED", "OTTI_NO_FUSED", "OTTI_FUSED_MAX_VARS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for n_cons, n_vars, n_in in ((3, 3, 1), (64, 64, 0), (4096, 100, 2), (4097, 10, 0),
                                 (100, 5000, 3), (1 << 13, 1 << 12, 0)):
        shape = r1cs.R1CSShape(n_cons, n_vars, n_in, [], [], [])
        assert cli._choose_fused(shape) == j_cli._choose_fused(shape), (n_cons, n_vars, env)


@pytest.mark.parametrize("zk,wire,env,want", [
    (True, "otti", {}, "zkfused.prove"),
    (True, "otti", {"OTTI_NO_FUSED": "1"}, "hybrid.prove_zk"),
    (True, "otti", {"OTTI_CLASSIC": "1"}, "zknizk.prove"),
    (True, "spartan", {}, "zknizk.prove"),
    (False, "otti", {}, "fused.prove"),
    (False, "otti", {"OTTI_FUSED_MAX_VARS": "2"}, "hybrid.prove"),
    (False, "otti", {"OTTI_CLASSIC": "1"}, "nizk.prove"),
])
def test_cli_picks_the_jax_clis_prover(monkeypatch, zk, wire, env, want):
    for k in ("OTTI_FUSED", "OTTI_NO_FUSED", "OTTI_FUSED_MAX_VARS", "OTTI_CLASSIC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    shape = r1cs.R1CSShape(64, 64, 0, [], [], [])
    prove_fn, _, classic = cli._provers(shape, zk, wire)
    if wire != "otti":  # the wire profile rides on zknizk.prove
        seen = {}
        orig = zknizk.prove
        monkeypatch.setattr(zknizk, "prove", lambda *a, **k: seen.setdefault("w", k["wire"]))
        prove_fn(None, [], [])
        monkeypatch.setattr(zknizk, "prove", orig)
        assert seen["w"] == wire and want == "zknizk.prove"
    else:
        mod, fn = want.split(".")
        assert prove_fn is getattr(globals()[mod], fn)
    assert classic == ("OTTI_CLASSIC" in env)


def _sgd_small():
    """The 8x3 data set of tests/test_codegen_sgd.py::test_sgd_nizk_end_to_end_small."""
    rng = np.random.default_rng(0)
    X = rng.integers(-5, 6, size=(8, 3))
    w_true = np.array([2, -1, 3])
    y = np.where(X @ w_true >= 0, 1, -1)
    for i in range(len(y)):
        while y[i] * (X[i] @ w_true) < 1:
            X[i] += y[i] * np.sign(w_true)
    return X, y


@pytest.fixture()
def tiny_config(tmp_path, monkeypatch):
    """The 8x3 data set as a cached PMLB file, and a config that names it."""
    X, y = _sgd_small()
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
    return str(cfg), tmp_path


def test_cli_classic_gives_the_same_bytes(tiny_config, monkeypatch, capsys):
    """Transparent proofs are deterministic: the CLI's default prover
    (fused.prove at this size) and OTTI_CLASSIC=1's (nizk.prove) write the
    same proof file; the meta's mode says which ran."""
    cfg, tmp = tiny_config
    monkeypatch.delenv("OTTI_CLASSIC", raising=False)
    texts, modes = [], []
    for classic in (False, True):
        if classic:
            monkeypatch.setenv("OTTI_CLASSIC", "1")
        out = tmp / ("classic" if classic else "default")
        assert cli.main(["--sgd", "--config", cfg, "--device", "cpu", "--transparent",
                         "--out", str(out)]) == 0
        texts.append((out / "SGD" / "tiny8x3.proof.json").read_text())
        with open(out / "SGD" / "tiny8x3.meta.json") as f:
            meta = json.load(f)
        modes.append(meta["mode"])
        assert meta["verified"]
        assert ("fused_prove_s" in meta["prover_metrics"]) != classic
    assert texts[0] == texts[1]
    assert modes == ["plain", "plain-classic"]
    assert "Verification successful for tiny8x3" in capsys.readouterr().out


def test_device_fs_provers_run_without_jax():
    """In a fresh interpreter (this one imported jax through conftest)."""
    code = (
        "import sys\n"
        "from otti_tpu_torch.spartan import fused, hybrid, nizk, r1cs, serial, zkfused, zknizk\n"
        "from otti_tpu_torch.curve import ristretto\n"
        "from otti_tpu_torch.transcript import device\n"
        "shape, zvars = r1cs.random_satisfiable(2, 2)\n"
        "dev = shape.to_device('cpu')\n"
        "p = hybrid.prove(dev, zvars, [])\n"
        "assert serial.dumps(p) == serial.dumps(nizk.prove(dev, zvars, []))\n"
        "assert nizk.verify(dev, [], p)\n"
        "seed = b'\\x07' * 32\n"
        "p = zkfused.prove(dev, zvars, [], seed=seed)\n"
        "assert serial.dumps(p) == serial.dumps(zknizk.prove(dev, zvars, [], seed=seed))\n"
        "assert zknizk.verify(dev, [], p)\n"
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


@pytest.mark.cuda
def test_device_fs_provers_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape, zvars = r1cs.random_satisfiable(64, 64)
    for prove, kw in ((fused.prove, {}), (hybrid.prove, {}), (zkfused.prove, {"seed": SEED}),
                      (hybrid.prove_zk, {"seed": SEED})):
        outs = [serial.dumps(prove(shape.to_device(d), zvars, [], **kw)) for d in ("cuda", "cpu")]
        assert outs[0] == outs[1], prove.__module__
