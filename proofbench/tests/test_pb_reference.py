"""The plain reference: its lowering is the program's R1CS entry for entry,
its verifier accepts the port's CPU proof and rejects altered ones, and it
imports nothing of the program."""

import json
import subprocess
import sys

import pytest
import torch

from proofbench import lpgen
from proofbench.reference import lowering, verify

from .conftest import REPO


def _program_lowering(tmp_path, A, b, c):
    from otti_tpu_torch.codegen import lp_cert
    from otti_tpu_torch.io import mps
    from otti_tpu_torch.oracle import lp_oracle

    path = str(tmp_path / "lp.mps")
    lpgen.write_mps(path, "lp", A, b, c)
    prob = mps.parse_mps(path)
    x, y, _ = lp_oracle.solve(prob)
    return lp_cert.build(prob, x, y)


@pytest.mark.parametrize("shape", [(3, 5, 8), (117, 225, 957)])
def test_reference_lowering_is_the_programs(tmp_path, shape):
    A, b, c = lpgen.make_lp(*shape, seed=2**31 + 1)
    prog, witness, inputs = _program_lowering(tmp_path, A, b, c)
    ref = lowering.lower(A, b, c)
    assert (ref.num_cons, ref.num_vars, ref.num_inputs) == (prog.num_cons, prog.num_vars, 0)
    for m, mat in enumerate((prog.A, prog.B, prog.C)):
        assert sorted(mat) == ref.entries(m)
    assert ref.digest() == prog.digest()
    assert ref.unsatisfied(witness, inputs) == 0
    assert ref.unsatisfied(witness[:-1] + [witness[-1] + 1], inputs) > 0


@pytest.fixture(scope="module")
def toy_proof(tmp_path_factory):
    from otti_tpu_torch.parallel import fused_prover
    from otti_tpu_torch.spartan import serial

    torch.set_num_threads(1)
    A, b, c = lpgen.make_lp(3, 5, 8, seed=9)
    shape, witness, inputs = _program_lowering(tmp_path_factory.mktemp("lp"), A, b, c)
    dev = shape.to_device("cpu")
    proof = fused_prover.prove_zk(dev, witness, inputs, k=1, seed=bytes(range(32)),
                                  devices=["cpu"])
    return lowering.lower(A, b, c), serial.dumps(proof)


def _alter(js: str, path: list, fn) -> str:
    d = json.loads(js)
    node = d
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = fn(node[path[-1]])
    return json.dumps(d)


def _bump_int(v):
    return {"__int__": hex(int(v["__int__"], 16) + 1)} if isinstance(v, dict) else v + 1


def _flip_byte(v):
    b = bytearray.fromhex(v["__bytes__"])
    b[0] ^= 2
    return {"__bytes__": b.hex()}


def test_reference_accepts_the_ports_proof(toy_proof):
    ref, js = toy_proof
    assert verify.verify(ref, [], js)


@pytest.mark.parametrize("path, fn", [
    (["bullet", "z1"], _bump_int),
    (["eq2", "z"], _bump_int),
    (["sc1", "dot_proofs", 0, "z_beta"], _bump_int),
    (["sc2", "comm_evals", 1], _flip_byte),
    (["comm_vars", 0], _flip_byte),
    (["comm_wq"], _flip_byte),
])
def test_reference_rejects_an_altered_proof(toy_proof, path, fn):
    ref, js = toy_proof
    assert not verify.verify(ref, [], _alter(js, path, fn))


def test_reference_rejects_another_instances_proof(toy_proof):
    _, js = toy_proof
    A, b, c = lpgen.make_lp(3, 5, 8, seed=10)
    assert not verify.verify(lowering.lower(A, b, c), [], js)
    assert not verify.verify(toy_proof[0], [], "not json")


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import proofbench.judge, proofbench.reference.verify, "
            "proofbench.reference.lowering; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('otti_tpu', 'otti_tpu_torch', 'jax', 'jaxlib', 'torch')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
