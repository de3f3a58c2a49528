"""The port's sharded provers (parallel/hybrid_sharded.py) against the JAX
package and against the port's single-device provers.

The instance is ``tests/test_nizk.py::random_instance(10, 8, 2, seed=1)``,
the shape tests/test_torch_batched.py already proves: 16 padded
constraints, 8 variables (2 Hyrax rows), 16 z entries.  So one shape takes
every branch: k = 2 commits block-sharded and runs 3 local rounds and 1 tail
round a phase, k = 4 commits on the controller (2 + 2 rounds in phase 1),
k = 8 runs 1 local round and 3 tail rounds.  The pieces are held one by one:
``partition_r1cs`` against the JAX function array for array, and each
shard's eq, Az/Bz/Cz, phase-2 table and z slice against the cyclic slices
[s::k] of the JAX ``mle.eq_table``, ``matvecs`` and ``matvec_T_weighted``,
and the sharded ``eval_at`` against the JAX one.  Then ``prove`` and
``prove_zk`` must give the bytes of the JAX ``nizk.prove`` /
``zknizk.prove`` (one blind seed) and of the port's ``hybrid`` provers,
also with the shards split over several groups in another order (as on
several cards); both packages' verifiers accept the proofs and reject them
for other inputs.  Here every shard sits on the CPU (the plain versions of
the kernels).  Tolerance: exact equality, this is modular arithmetic.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from otti_tpu.field.fields import SCALAR, ints_to_limbs, limbs_to_int
from otti_tpu.parallel import fused_prover as JFP
from otti_tpu.spartan import mle as JM
from otti_tpu.spartan import nizk as JN
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import zknizk as JZ
from otti_tpu_torch import cli
from otti_tpu_torch.parallel import hybrid_sharded as HS
from otti_tpu_torch.spartan import hybrid as TH
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import zknizk as TZ
from tests.test_nizk import random_instance
from tests.test_torch_device_fs import _sgd_small

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = b"\x2a" * 32
CPU = torch.device("cpu")
# (k, shard groups): one group of every shard (one device), and splits
# whose groups come out of shard order, as shards on several devices do
LAYOUTS = [(2, None), (4, None), (8, None), (2, [[1], [0]]), (4, [[1, 3], [0], [2]])]
_SHARDS = HS._Shards


def _ints(arr) -> list:
    """Limb rows (any semi form) -> canonical ints, flat."""
    return [limbs_to_int(row) % M for row in np.asarray(arr).reshape(-1, 22)]


def _rand_limbs(rng, n) -> np.ndarray:
    vals = [int.from_bytes(rng.bytes(32), "little") % M for _ in range(n)]
    return np.asarray(ints_to_limbs(vals), np.int32).reshape(n, 22)


def _shards(dev, k, groups=None):
    """k shards on the CPU: one group, or ``groups`` (lists of shard ids,
    the first holding the controller's place)."""
    sh = _SHARDS(dev, k, [CPU] * k)
    if groups is not None:
        order = [s for g in groups for s in g]
        sh.groups = [(CPU, list(g)) for g in groups]
        sh.unperm = torch.tensor(np.argsort(order))
    return sh


@pytest.fixture(scope="module")
def inst():
    shape_j, vars_, ios = random_instance(10, 8, 2, seed=1)
    shape_t = TR.R1CSShape(shape_j.num_cons, shape_j.num_vars, shape_j.num_inputs,
                           list(shape_j.A), list(shape_j.B), list(shape_j.C))
    dev_t = shape_t.to_device("cpu")
    assert (dev_t.num_cons, dev_t.num_vars, dev_t.num_z) == (16, 8, 16)
    return dict(dev_j=shape_j.to_device(), shape_t=shape_t, dev_t=dev_t, vars=vars_,
                inputs=ios)


@pytest.fixture(scope="module")
def refs(inst):
    """The JAX package's proofs and the port's single-device ones."""
    dj, dt, v, i = inst["dev_j"], inst["dev_t"], inst["vars"], inst["inputs"]
    return dict(plain=JS.dumps(JN.prove(dj, v, i)), zk=JS.dumps(JZ.prove(dj, v, i, seed=SEED)),
                plain_t=TS.dumps(TH.prove(dt, v, i)),
                zk_t=TS.dumps(TH.prove_zk(dt, v, i, seed=SEED)))


# ---- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4, 8])
def test_partition_matches_jax(inst, k):
    """The same arrays as the JAX function on the port's entries (the JAX
    R1CSDevice pads its nnz, so it is given the port's)."""
    dev = inst["dev_t"]
    mats = tuple(tuple(x.numpy() for x in m) for m in dev.mats)
    want = JFP.partition_r1cs(types.SimpleNamespace(digest=b"port" + dev.digest, mats=mats), k)
    got = HS.partition_r1cs(dev, k)
    assert HS.partition_r1cs(dev, k) is got  # cached
    for side_t, side_j in zip(got, want):
        for tri_t, tri_j in zip(side_t, side_j):
            for a, b in zip(tri_t, tri_j):
                assert tuple(a.shape) == tuple(b.shape)
                assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k,groups", LAYOUTS)
def test_shard_tables_are_the_cyclic_slices(inst, k, groups):
    dj, dt = inst["dev_j"], inst["dev_t"]
    rng = np.random.default_rng(30 + k)
    sh = _shards(dt, k, groups)
    parts = HS._group_parts(dt, sh)
    tau = _rand_limbs(rng, 4)
    z = _rand_limbs(rng, dt.num_z)
    tabs = HS._tables1(sh, sh.put(torch.from_numpy(tau)), sh.put(torch.from_numpy(z)), parts,
                       dt.num_cons)
    wants = [JM.eq_table(tau)] + list(dj.matvecs(z))
    for (_, ss), group in zip(sh.groups, tabs):
        for got, want in zip(group, wants):
            assert tuple(got.shape) == (len(ss), dt.num_cons // k, 22)
            for g, s in enumerate(ss):
                assert _ints(got[g]) == _ints(np.asarray(want)[s::k])
    # the survivors, gathered into shard order
    for q, got in enumerate(sh.gather(tabs)):
        assert _ints(got) == _ints(np.asarray(wants[q])[:k])

    w, e_rx, e_ry = _rand_limbs(rng, 3), _rand_limbs(rng, dt.num_cons), _rand_limbs(rng, dt.num_z)
    m = HS._mtable(sh, torch.from_numpy(w), torch.from_numpy(e_rx), parts)
    want = np.asarray(dj.matvec_T_weighted(tuple(w), e_rx))
    for (_, ss), got in zip(sh.groups, m):
        for g, s in enumerate(ss):
            assert _ints(got[g]) == _ints(want[s::k])
    got = HS._eval_at(sh, torch.from_numpy(e_rx), torch.from_numpy(e_ry), parts)
    assert _ints(got) == _ints(np.stack(dj.eval_at(e_rx, e_ry)))

    _, _, z_loc, _ = HS._setup(sh, dt, inst["vars"], inst["inputs"])
    z_full = TR.assemble_z(TN._vec(inst["vars"], "cpu"), TN._vec(inst["inputs"], "cpu"),
                           dt.num_vars)
    for (_, ss), got in zip(sh.groups, z_loc):
        for g, s in enumerate(ss):
            assert torch.equal(got[g], z_full[s::k])


# ---- the provers --------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4, 8])
def test_prove_is_byte_equal_to_jax_and_hybrid(inst, refs, k):
    dt, v, i = inst["dev_t"], inst["vars"], inst["inputs"]
    got = TS.dumps(HS.prove(dt, v, i, k=k, devices=[CPU] * k))
    assert got == refs["plain"] == refs["plain_t"]


@pytest.mark.parametrize("k", [2, 4, 8])
def test_prove_zk_is_byte_equal_to_jax_and_hybrid(inst, refs, k):
    dt, v, i = inst["dev_t"], inst["vars"], inst["inputs"]
    got = TS.dumps(HS.prove_zk(dt, v, i, k=k, seed=SEED, devices=[CPU] * k))
    assert got == refs["zk"] == refs["zk_t"]


@pytest.mark.parametrize("k,groups", LAYOUTS[3:])
def test_shards_split_over_groups_give_the_same_bytes(inst, refs, monkeypatch, k, groups):
    dt, v, i = inst["dev_t"], inst["vars"], inst["inputs"]
    monkeypatch.setattr(HS, "_Shards", lambda dev, k_, devices, group: _shards(dev, k_, groups))
    assert TS.dumps(HS.prove(dt, v, i, k=k)) == refs["plain"]


def test_both_verifiers_accept_and_reject_other_inputs(inst, refs):
    dj, dt, i = inst["dev_j"], inst["dev_t"], inst["inputs"]
    other = [(x + 1) % M for x in i]
    plain, zk = TS.loads(refs["plain"]), TS.loads(refs["zk"])
    assert TN.verify(dt, i, plain) and TZ.verify(dt, i, zk)
    assert JN.verify(dj, i, JS.loads(refs["plain"])) and JZ.verify(dj, i, JS.loads(refs["zk"]))
    assert not TN.verify(dt, other, plain) and not TZ.verify(dt, other, zk)
    assert not JN.verify(dj, other, JS.loads(refs["plain"]))
    assert not JZ.verify(dj, other, JS.loads(refs["zk"]))


@pytest.mark.parametrize("k,devices,needle", [
    (16, [CPU] * 16, "instance too small for 16 shards"),  # num_z = 16 < 2k
    (3, [CPU] * 3, "power of two"),
    (2, [CPU] * 4, "2 shards and 4 devices"),
    (64, None, "64 shards need as many CUDA devices"),
    (2, ["cuda:0", "cuda:1"], "is not a cpu device"),
])
def test_bad_shard_arguments_raise(inst, k, devices, needle):
    dt, v, i = inst["dev_t"], inst["vars"], inst["inputs"]
    with pytest.raises(ValueError, match=needle):
        HS.prove(dt, v, i, k=k, devices=devices)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [[0, 1], [0, 1, 0, 1]])
def test_shards_on_distinct_cards_give_the_same_bytes(inst, refs, cards):
    """Shard groups on two cards (cuda:1 holds every odd shard): each
    launch runs on its tensors' card, whose constants its library uploads
    at the first launch there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    v, i, k = inst["vars"], inst["inputs"], len(cards)
    dev = inst["shape_t"].to_device("cuda:0")
    devices = [torch.device("cuda", c) for c in cards]
    assert TS.dumps(HS.prove(dev, v, i, k=k, devices=devices)) == refs["plain"]
    assert TS.dumps(HS.prove_zk(dev, v, i, k=k, seed=SEED, devices=devices)) == refs["zk"]


# ---- the command line ---------------------------------------------------------

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
    return str(cfg), tmp_path / "out"


def _meta(out):
    with open(out / "SGD" / "tiny8x3.meta.json") as f:
        return json.load(f)


def test_run_sgd_mesh_proves_over_two_devices(tiny_config, capsys, monkeypatch):
    """Two devices visible (two CPU shards here): the zk prove is sharded,
    verified, and its meta says mesh2."""
    cfg, out = tiny_config
    monkeypatch.setattr(cli, "_visible_devices", lambda device: [CPU, CPU])
    calls = []
    sharded = HS.prove_zk
    monkeypatch.setattr(HS, "prove_zk", lambda *a, **kw: calls.append(kw) or sharded(*a, **kw))
    assert cli.run_sgd(cfg, str(out), device="cpu", mesh="2")
    assert "Verification successful for tiny8x3" in capsys.readouterr().out
    assert calls == [{"k": 2, "devices": [CPU, CPU]}]
    meta = _meta(out)
    assert meta["mode"] == "zk-mesh2" and meta["verified"]


def test_cli_mesh_on_one_visible_device_proves_on_one(tiny_config, capsys):
    """--mesh 4 with one device visible resolves to k = 1: the
    single-device prover, and no mesh in the meta."""
    cfg, out = tiny_config
    rc = cli.main(["--sgd", "--config", cfg, "--device", "cpu", "--out", str(out),
                   "--transparent", "--mesh", "4"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "Proving tiny8x3:" in text and "Verification successful for tiny8x3" in text
    assert _meta(out)["mode"] == "plain"


def test_sharded_prover_imports_no_jax():
    """In a fresh interpreter (this one imported jax through conftest): a
    sharded prove on two CPU shards by hybrid_sharded and by fused_prover,
    the same bytes, and no jax nor JAX package module."""
    code = (
        "import sys\n"
        "from otti_tpu_torch.parallel import fused_prover, hybrid_sharded\n"
        "from otti_tpu_torch.spartan import nizk, r1cs, serial\n"
        "shape, zvars = r1cs.random_satisfiable(8, 8)\n"
        "dev = shape.to_device('cpu')\n"
        "proof = hybrid_sharded.prove(dev, zvars, [], k=2, devices=['cpu', 'cpu'])\n"
        "assert nizk.verify(dev, [], proof)\n"
        "mono = fused_prover.prove(dev, zvars, [], k=2, devices=['cpu', 'cpu'])\n"
        "assert serial.dumps(mono) == serial.dumps(proof)\n"
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
