"""The port's transparent NIZK end to end against otti_tpu.spartan.nizk.

On the same instance both packages must produce byte-equal proofs
(``serial.dumps``), each verifier must accept the other's proof after a
JSON round trip, and a changed public input must be rejected.  The port
runs on the CPU here (plain versions of its kernels).  A subprocess check
proves that the port runs without importing jax or any module of otti_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from otti_tpu.codegen import sgd_cert as j_sgd_cert
from otti_tpu.io import pmlb_local
from otti_tpu.oracle import sgd_oracle
from otti_tpu.spartan import nizk as JN
from otti_tpu.spartan import serial as JS
from otti_tpu_torch.codegen import sgd_cert as t_sgd_cert
from otti_tpu_torch.spartan import fused as TF
from otti_tpu_torch.spartan import hybrid as TH
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    # the toy R1CS at the padded shape of the SGD instance below (64
    # constraints, 64 variables), so that the JAX prover compiles for one
    # set of shapes
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
        out[name] = dict(
            dev_j=dev_j, dev_t=dev_t, inputs=inputs, vars=vars_,
            jax=JN.prove(dev_j, vars_, inputs), port=TN.prove(dev_t, vars_, inputs),
        )
    return out


def test_sgd_iris_lowering_digest_matches_jax():
    X, y, src = pmlb_local.fetch("iris", 0, 1, seed=3)
    assert src == "pmlb_cache"
    w = sgd_oracle.solve(X, y, seed=3)
    shape_j, vars_j, inputs_j = j_sgd_cert.build(X, y, w)
    shape_t, vars_t, inputs_t = t_sgd_cert.build(X, y, w)
    assert shape_t.digest() == shape_j.digest()
    assert (vars_t, inputs_t) == (vars_j, inputs_j)
    assert shape_t.num_cons_padded == shape_j.num_cons_padded
    assert shape_t.num_vars_padded == shape_j.num_vars_padded
    assert shape_t.is_satisfied(vars_t, inputs_t)


@pytest.mark.parametrize("name", ["toy", "sgd8x3"])
def test_proof_bytes_equal_jax(proved, name):
    p = proved[name]
    assert TS.dumps(p["port"]) == JS.dumps(p["jax"])
    assert p["port"].size_bytes() == p["jax"].size_bytes()


@pytest.mark.parametrize("name", ["toy", "sgd8x3"])
def test_each_verifier_accepts_the_others_proof(proved, name):
    p = proved[name]
    assert TN.verify(p["dev_t"], p["inputs"], p["port"])
    assert JN.verify(p["dev_j"], p["inputs"], JS.loads(TS.dumps(p["port"])))
    assert TN.verify(p["dev_t"], p["inputs"], TS.loads(JS.dumps(p["jax"])))


@pytest.mark.parametrize("name", ["toy", "sgd8x3"])
def test_device_fs_provers_equal_jax(proved, name):
    """fused.prove and hybrid.prove (the transcript on the device) give the
    JAX package's nizk.prove bytes; its verifier accepts them."""
    p = proved[name]
    for prove in (TF.prove, TH.prove):
        proof = prove(p["dev_t"], p["vars"], p["inputs"])
        assert TS.dumps(proof) == JS.dumps(p["jax"]), prove.__module__
        assert JN.verify(p["dev_j"], p["inputs"], JS.loads(TS.dumps(proof)))


def test_changed_public_input_or_claim_is_rejected(proved):
    p = proved["sgd8x3"]
    bad = [(p["inputs"][0] + 1) % TN.MOD] + p["inputs"][1:]
    assert not TN.verify(p["dev_t"], bad, p["port"])
    assert not JN.verify(p["dev_j"], bad, JS.loads(TS.dumps(p["port"])))
    forged = TS.loads(TS.dumps(p["port"]))
    forged.claim_w = (forged.claim_w + 1) % TN.MOD
    assert not TN.verify(p["dev_t"], p["inputs"], forged)


def test_proto_changes_the_proof_and_the_default_does_not(proved):
    """``prove(..., proto)`` as in the JAX package: the default is the NIZK's
    own label, another label gives another proof, equal to the JAX package's
    under that label, that the NIZK's verifier does not accept."""
    p = proved["sgd8x3"]
    assert TS.dumps(TN.prove(p["dev_t"], p["vars"], p["inputs"], proto=TN.PROTO)) \
        == TS.dumps(p["port"])
    other = TN.prove(p["dev_t"], p["vars"], p["inputs"], proto=b"another protocol")
    assert TS.dumps(other) != TS.dumps(p["port"])
    assert other.comm_vars == p["port"].comm_vars  # the witness commitment is not the label's
    assert not TN.verify(p["dev_t"], p["inputs"], other)
    assert TS.dumps(other) == JS.dumps(
        JN.prove(p["dev_j"], p["vars"], p["inputs"], proto=b"another protocol"))


def test_port_runs_without_jax():
    """In a fresh interpreter (this one imported jax through conftest)."""
    code = (
        "import sys\n"
        "from otti_tpu_torch.spartan import nizk, r1cs, serial\n"
        "shape, zvars = r1cs.random_satisfiable()\n"
        "dev = shape.to_device('cpu')\n"
        "proof = nizk.prove(dev, zvars, [])\n"
        "assert nizk.verify(dev, [], proof)\n"
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
