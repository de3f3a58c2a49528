"""The port's single-dispatch sharded provers (parallel/fused_prover.py)
against the JAX package and the port's single-device provers.

On the 8x3 SGD instance of tests/test_torch_nizk.py (64 padded constraints
and variables), ``prove`` over k = 1, 2 and 4 shards must give the bytes of
the JAX package's ``fused.prove``, and ``prove_zk`` with one blind seed the
bytes of its ``zknizk.prove``; both packages' verifiers accept them and
reject a tampered proof.  On the random R1CS shapes of
tests/test_fused_sharded.py ((64, 32, 3) and (130, 90, 5)) at k = 2 and 8,
``prove`` must give the bytes of the port's ``fused.prove``.  Every shard sits
on the CPU here, where the core runs uncaptured (the plain versions of the
kernels); the choice of a captured CUDA graph is held as a decision on the
configuration, and one card test replays the captured core for two
instances and two seeds against the eager provers.  The CLI picks these
provers under ``OTTI_MESH_MONOLITHIC=1``.  Tolerance: exact equality, this
is modular arithmetic.
"""

import dataclasses
import json
import random

import pytest
import torch

from otti_tpu.codegen import sgd_cert as j_sgd_cert
from otti_tpu.spartan import fused as JF
from otti_tpu.spartan import nizk as JN
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import zknizk as JZ
from otti_tpu_torch import cli
from otti_tpu_torch.codegen import sgd_cert as t_sgd_cert
from otti_tpu_torch.field.fields import SCALAR
from otti_tpu_torch.parallel import fused_prover as FP
from otti_tpu_torch.parallel import hybrid_sharded as HS
from otti_tpu_torch.spartan import fused as TF
from otti_tpu_torch.spartan import hybrid as TH
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import zknizk as TZ
from otti_tpu_torch.transcript.merlin import Transcript
from tests.test_torch_mesh import tiny_config  # noqa: F401  (a fixture)
from tests.test_torch_nizk import _sgd_small

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus
SEED = b"\x3c" * 32
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sgd():
    """The 8x3 instance on both packages' devices, and the JAX package's
    plain (fused.prove) and zk (zknizk.prove, SEED) proofs of it."""
    X, y, w = _sgd_small()
    shape_j, vars_, inputs = j_sgd_cert.build(X, y, w)
    shape_t, vars_t, inputs_t = t_sgd_cert.build(X, y, w)
    assert (vars_t, inputs_t) == (vars_, inputs)
    dev_j, dev_t = shape_j.to_device(), shape_t.to_device("cpu")
    assert (dev_t.num_cons, dev_t.num_vars) == (64, 64)
    return dict(dev_j=dev_j, dev_t=dev_t, shape_t=shape_t, vars=vars_, inputs=inputs,
                plain=JS.dumps(JF.prove(dev_j, vars_, inputs)),
                zk=JS.dumps(JZ.prove(dev_j, vars_, inputs, seed=SEED)), zk_proofs={})


def _zk_proof(sgd, k):
    """prove_zk over k CPU shards (SEED), once a module for each k."""
    if k not in sgd["zk_proofs"]:
        sgd["zk_proofs"][k] = FP.prove_zk(sgd["dev_t"], sgd["vars"], sgd["inputs"], k=k,
                                          seed=SEED, devices=[CPU] * k)
    return sgd["zk_proofs"][k]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_prove_is_the_jax_fused_provers_bytes(sgd, k):
    dt, v, i = sgd["dev_t"], sgd["vars"], sgd["inputs"]
    proof = FP.prove(dt, v, i, k=k, devices=[CPU] * k)
    assert TS.dumps(proof) == sgd["plain"]
    assert TN.verify(dt, i, proof)
    assert JN.verify(sgd["dev_j"], i, JS.loads(TS.dumps(proof)))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_prove_zk_is_the_jax_zknizk_provers_bytes(sgd, k):
    assert TS.dumps(_zk_proof(sgd, k)) == sgd["zk"]


def test_both_verifiers_accept_the_zk_proof_and_reject_it_tampered(sgd):
    dj, dt, i = sgd["dev_j"], sgd["dev_t"], sgd["inputs"]
    proof = _zk_proof(sgd, 2)
    assert TZ.verify(dt, i, proof)
    assert JZ.verify(dj, i, JS.loads(TS.dumps(proof)))
    bad = dataclasses.replace(proof, bullet=dataclasses.replace(
        proof.bullet, z1=(proof.bullet.z1 + 1) % M))
    assert not TZ.verify(dt, i, bad)
    assert not JZ.verify(dj, i, JS.loads(TS.dumps(bad)))
    other = [(x + 1) % M for x in i]
    assert not TZ.verify(dt, other, proof)


def _random_r1cs(n_cons, n_vars, n_inputs, seed):
    """tests/test_fused_sharded.py::_random_r1cs on the port's R1CSShape."""
    r = random.Random(seed)
    zvars = [r.randrange(M) for _ in range(n_vars)]
    inputs = [r.randrange(1, 1000) for _ in range(n_inputs)]
    full = zvars + [1] + inputs
    A, B, C = [], [], []
    for row in range(n_cons):
        ca, cb = r.randrange(len(full)), r.randrange(len(full))
        va, vb = r.randrange(1, 99), r.randrange(1, 99)
        A.append((row, ca, va))
        B.append((row, cb, vb))
        C.append((row, n_vars, va * full[ca] % M * (vb * full[cb] % M) % M))
    return TR.R1CSShape.from_logical(n_cons, n_vars, n_inputs, A, B, C), zvars, inputs


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("n_cons,n_vars,n_inputs", [(64, 32, 3), (130, 90, 5)])
def test_random_r1cs_gives_the_fused_provers_bytes(k, n_cons, n_vars, n_inputs):
    shape, zvars, inputs = _random_r1cs(n_cons, n_vars, n_inputs, n_cons + k)
    dev = shape.to_device("cpu")
    proof = FP.prove(dev, zvars, inputs, k=k, devices=[CPU] * k)
    assert TS.dumps(proof) == TS.dumps(TF.prove(dev, zvars, inputs))
    assert TN.verify(dev, inputs, proof)


# ---- the capture: decided by the configuration ---------------------------------

@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], False),  # the CPU runs the core eagerly
    (["cuda:0", "cuda:0", "cuda:0", "cuda:0"], True),  # k shards on one card
    (["cuda:0"], True),
    (["cuda:0", "cuda:1"], False),  # a torch graph belongs to one device
    (["cuda:1", "cuda:0", "cuda:1"], False),
])
def test_captures_where_every_shard_sits_on_one_card(devices, want):
    assert FP.captures([torch.device(d) for d in devices]) is want


def test_static_inputs_are_copies_in_a_fixed_order(sgd):
    """The graph's static inputs: a deep copy of the core's inputs (the
    partitions are views of a cache), flattened in the same order as any
    other prove's inputs of the key."""
    dt = sgd["dev_t"]
    sh = HS._Shards(dt, 2, [CPU] * 2)
    t = HS._start(Transcript(TN.PROTO), dt, sgd["inputs"])
    ins, offsets = FP._inputs(sh, dt, t, sgd["vars"], sgd["inputs"])
    static = FP._clone(ins)
    a, b = FP._leaves(ins), FP._leaves(static)
    assert len(a) == len(b) == 2 + 3 * 3 * 3  # state, z, a group's row/col/eval matrices
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    assert FP._key(False, sh, dt, offsets, ins) == FP._key(False, sh, dt, offsets, static)
    assert FP._key(False, sh, dt, offsets, ins) != FP._key(True, sh, dt, offsets, ins)


# ---- the command line ----------------------------------------------------------

@pytest.mark.parametrize("zk", [False, True])
def test_cli_monolithic_picks_fused_prover(monkeypatch, sgd, zk):
    """OTTI_MESH_MONOLITHIC=1 with a mesh of two (two CPUs visible): the
    prove function is fused_prover's, uncaptured on the CPU; without it,
    hybrid_sharded's."""
    monkeypatch.setattr(cli, "_visible_devices", lambda device: [CPU, CPU])
    calls = []
    for mod in (FP, HS):
        for name in ("prove", "prove_zk"):
            monkeypatch.setattr(mod, name, lambda *a, _m=mod, _n=name, **kw:
                                calls.append((_m.__name__.rsplit(".", 1)[-1], _n, kw)))
    shape = sgd["shape_t"]
    want = "prove_zk" if zk else "prove"
    monkeypatch.setenv("OTTI_MESH_MONOLITHIC", "1")
    prove_fn, _, _ = cli._provers(shape, zk, "otti", 2, "cpu")
    prove_fn(sgd["dev_t"], sgd["vars"], sgd["inputs"])
    assert prove_fn.graph is False
    monkeypatch.delenv("OTTI_MESH_MONOLITHIC")
    cli._provers(shape, zk, "otti", 2, "cpu")[0](sgd["dev_t"], sgd["vars"], sgd["inputs"])
    assert calls == [("fused_prover", want, {"k": 2, "devices": [CPU, CPU]}),
                     ("hybrid_sharded", want, {"k": 2, "devices": [CPU, CPU]})]


def test_run_sgd_monolithic_mesh_writes_graph_in_the_meta(tiny_config, capsys,  # noqa: F811
                                                          monkeypatch):
    cfg, out = tiny_config
    monkeypatch.setattr(cli, "_visible_devices", lambda device: [CPU, CPU])
    monkeypatch.setenv("OTTI_MESH_MONOLITHIC", "1")
    calls = []
    mono = FP.prove
    monkeypatch.setattr(FP, "prove", lambda *a, **kw: calls.append(kw) or mono(*a, **kw))
    assert cli.run_sgd(cfg, str(out), zk=False, device="cpu", mesh="2")
    assert "Verification successful for tiny8x3" in capsys.readouterr().out
    assert calls == [{"k": 2, "devices": [CPU, CPU]}]
    with open(out / "SGD" / "tiny8x3.meta.json") as f:
        meta = json.load(f)
    assert (meta["mode"], meta["graph"], meta["verified"]) == ("plain-mesh2", False, True)


# ---- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_replay_equals_the_eager_provers_on_the_card():
    """Two instances of one class and two seeds through the captured core
    (2 shards on cuda:0): each replay gives the eager provers' bytes.  The
    generator's seeds 7 and 9 give shard parts of the same padded sizes,
    so the second instance replays the first one's graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    FP.clear_graphs()
    for seed_r1cs, blind in ((7, b"\x01" * 32), (9, b"\x02" * 32)):
        shape, zvars = TR.random_satisfiable(64, 64, seed=seed_r1cs)
        dev = shape.to_device(card)
        assert TS.dumps(FP.prove(dev, zvars, [], k=2, devices=[card] * 2)) == \
            TS.dumps(TH.prove(dev, zvars, []))
        assert TS.dumps(FP.prove_zk(dev, zvars, [], k=2, seed=blind, devices=[card] * 2)) == \
            TS.dumps(TH.prove_zk(dev, zvars, [], seed=blind))
    assert [g["replays"] for g in FP.graphs()] == [2, 2]
    FP.clear_graphs()
