"""The port's batched provers (spartan/batched.py) against the JAX package's
and against its own single-instance provers.

Instances are ``tests/test_nizk.py::random_instance(10, 8, 2, seed=s)``,
whose shape tests/test_batched.py already compiles on the JAX side.  The
pieces of the batched chain are held one by one: ``to_device`` with a
forced padding against the JAX ``to_device``, ``BatchedR1CS``'s products
against the JAX ``BatchedR1CS``, a ``[B, 200]`` device transcript against
B host transcripts, and the batched sumcheck round against B single
rounds.  Then ``prove_many`` must give the JAX ``batched.prove_many``'s
bytes, and ``prove_many_zk`` with one seed an instance the bytes of the
port's ``zknizk.prove`` (and on one instance of the JAX ``zknizk.prove``);
both packages' verifiers accept the proofs, and a proof fails for another
instance's inputs.  The port runs on the CPU here (plain versions of its
kernels).  Tolerance: exact equality, this is modular arithmetic.
"""

import numpy as np
import pytest
import torch

from otti_tpu.field.fields import SCALAR, ints_to_limbs, limbs_to_int
from otti_tpu.spartan import batched as JB
from otti_tpu.spartan import mle as JM
from otti_tpu.spartan import nizk as JN
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import zknizk as JZ
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.spartan import batched as TB
from otti_tpu_torch.spartan import hybrid as TH
from otti_tpu_torch.spartan import mle as TM
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import sumcheck_kernels as SK
from otti_tpu_torch.spartan import zknizk as TZ
from otti_tpu_torch.transcript.device import DeviceStrobe, DeviceTranscript, export_host_strobe
from otti_tpu_torch.transcript.merlin import Transcript
from tests.test_nizk import random_instance

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus
SEEDS = (1, 2, 3)  # tests/test_batched.py's instances
ZK_SEEDS = [bytes([40 + b]) * 32 for b in range(3)]


def _port_shape(shape_j):
    s = TR.R1CSShape(shape_j.num_cons, shape_j.num_vars, shape_j.num_inputs,
                     list(shape_j.A), list(shape_j.B), list(shape_j.C))
    assert s.digest() == shape_j.digest()
    return s


def _ints(arr) -> list:
    """Limb rows (any semi form) -> canonical ints, flat."""
    a = np.asarray(arr).reshape(-1, 22)
    return [limbs_to_int(row) % M for row in a]


def _rand_limbs(rng, shape) -> np.ndarray:
    vals = [int.from_bytes(rng.bytes(32), "little") % M for _ in range(int(np.prod(shape)))]
    return np.asarray(ints_to_limbs(vals), np.int32).reshape(tuple(shape) + (22,))


@pytest.fixture(scope="module")
def insts():
    out = []
    for s in SEEDS:
        shape_j, vars_, ios = random_instance(10, 8, 2, seed=s)
        out.append(dict(shape_j=shape_j, dev_j=shape_j.to_device(),
                        dev_t=_port_shape(shape_j).to_device("cpu"), vars=vars_, inputs=ios))
    return out


@pytest.fixture(scope="module")
def plain(insts):
    args = ([i["vars"] for i in insts], [i["inputs"] for i in insts])
    return (JB.prove_many([i["dev_j"] for i in insts], *args),
            TB.prove_many([i["dev_t"] for i in insts], *args))


@pytest.fixture(scope="module")
def zk(insts):
    return TB.prove_many_zk([i["dev_t"] for i in insts], [i["vars"] for i in insts],
                            [i["inputs"] for i in insts], seeds=ZK_SEEDS)


# ---- the pieces ---------------------------------------------------------------

def test_to_device_with_forced_padding_matches_jax(insts):
    """One power of two up in both dimensions: the io half moves, as in JAX."""
    shape_j = insts[0]["shape_j"]
    shape_t = _port_shape(shape_j)
    ncp, nvp = shape_j.num_cons_padded, shape_j.num_vars_padded
    dj = shape_j.to_device(min_cons=2 * ncp, min_vars=2 * nvp)
    dt = shape_t.to_device("cpu", min_cons=2 * ncp, min_vars=2 * nvp)
    assert (dt.num_cons, dt.num_z, dt.num_vars) == (dj.num_cons, dj.num_z, dj.num_vars)
    assert (dt.num_cons, dt.num_vars) == (2 * ncp, 2 * nvp)
    assert dt.digest == dj.digest == shape_j.digest()
    for (rj, cj, vj), (rt, ct, vt), mat in zip(dj.mats, dt.mats, (shape_j.A, shape_j.B, shape_j.C)):
        k = len(mat)
        assert rt.shape[0] == k
        assert np.array_equal(np.asarray(rj)[:k], rt.numpy())
        assert np.array_equal(np.asarray(cj)[:k], ct.numpy())
        assert np.array_equal(np.asarray(vj)[:k], vt.numpy())
        assert not np.asarray(vj)[k:].any()  # JAX's nnz padding: value 0
    assert any(c >= 2 * nvp for c in dt.mats[0][1].tolist())  # the shifted io half is used


def test_batched_r1cs_products_match_jax(insts):
    rng = np.random.default_rng(11)
    bj = JB.BatchedR1CS([i["dev_j"] for i in insts])
    bt = TB.BatchedR1CS([i["dev_t"] for i in insts])
    nb, ncons, nz = len(insts), bt.num_cons, bt.num_z
    assert (bt.num_cons, bt.num_z, bt.num_vars) == (bj.num_cons, bj.num_z, bj.num_vars)
    zs = _rand_limbs(rng, (nb, nz))
    for got, want in zip(bt.matvecs(torch.from_numpy(zs)), bj.matvecs(zs)):
        assert tuple(got.shape) == (nb, ncons, 22)
        assert _ints(got) == _ints(want)
    w = _rand_limbs(rng, (nb, 3))
    e_rx = _rand_limbs(rng, (nb, ncons))
    got = bt.matvec_T_weighted(torch.from_numpy(w).unbind(1), torch.from_numpy(e_rx))
    assert tuple(got.shape) == (nb, nz, 22)
    assert _ints(got) == _ints(bj.matvec_T_weighted(w, e_rx))
    e_ry = _rand_limbs(rng, (nb, nz))
    got = TB.eval_at_batched(bt, torch.from_numpy(e_rx), torch.from_numpy(e_ry))
    assert tuple(got.shape) == (nb, 3, 22)
    assert _ints(got) == _ints(JB.eval_at_batched(bj, e_rx, e_ry))


def test_eq_table_over_a_batch_axis():
    rng = np.random.default_rng(12)
    r = _rand_limbs(rng, (3, 4))
    got = TM.eq_table(torch.from_numpy(r))
    assert tuple(got.shape) == (3, 16, 22)
    for b in range(3):
        assert _ints(got[b]) == _ints(JM.eq_table(r[b]))
        assert _ints(got[b]) == _ints(TM.eq_table(torch.from_numpy(r[b])))


def test_device_transcript_of_b_states_matches_b_host_transcripts():
    """B host transcripts fed different messages, and one [B, 200] device
    transcript fed them as [B, n] rows: the same challenges and states,
    across the rate boundary and through every operation kind."""
    rng = np.random.default_rng(13)
    nb = 3
    hosts = [Transcript(b"batched transcript test") for _ in range(nb)]
    for b, h in enumerate(hosts):  # the instances part ways before the handoff
        h.append_message(b"instance", bytes([b]) * (5 + b))
        h.challenge_scalar(b"sync")
    offs = [export_host_strobe(h.strobe)[1:] for h in hosts]
    assert len(set(offs)) == 1
    state = torch.from_numpy(np.stack([export_host_strobe(h.strobe)[0] for h in hosts]))
    dev = DeviceTranscript(_strobe=DeviceStrobe.from_state(state, *offs[0]))
    for n in (5, 32, 200):
        msgs = rng.integers(0, 256, size=(nb, n), dtype=np.uint8)
        dev.append_message(b"msg", torch.from_numpy(msgs))
        for h, m in zip(hosts, msgs):
            h.append_message(b"msg", m.tobytes())
        dev.append_u64(b"shared", 7)
        for h in hosts:
            h.append_u64(b"shared", 7)
        vals = [[int.from_bytes(rng.bytes(32), "little") % M for _ in range(nb)]]
        dev.append_scalar_limbs(b"s", F.from_ints(SCALAR, vals[0]))
        for h, v in zip(hosts, vals[0]):
            h.append_scalar(b"s", v.to_bytes(32, "little"))
        got = dev.challenge_scalar_limbs(b"c")
        assert tuple(got.shape) == (nb, 22)
        assert _ints(got) == [h.challenge_scalar(b"c") for h in hosts]
        got = dev.challenge_vector_limbs(b"v", 2)
        assert tuple(got.shape) == (nb, 2, 22)
        assert _ints(got) == [x for h in hosts for x in h.challenge_vector(b"v", 2)]
        got = dev.challenge_bytes(b"b", 100)
        assert [bytes(row.tolist()) for row in got] == [h.challenge_bytes(b"b", 100) for h in hosts]
    for b, h in enumerate(hosts):
        st, pos, pos_begin, flags = export_host_strobe(h.strobe)
        assert bytes(dev.strobe.state[b].tolist()) == st.tobytes()
        assert (pos, pos_begin, flags) == dev.strobe.offsets
    with pytest.raises(ValueError):
        DeviceStrobe.from_state(torch.zeros(3, 199, dtype=torch.uint8), *offs[0])


@pytest.mark.parametrize("degree", [3, 2])
def test_batched_round_equals_single_rounds(degree):
    """The batched plain round (kernel 2's reference over [B, n, 22]) is B
    single rounds, with one challenge an instance, down to the bare final
    bind."""
    rng = np.random.default_rng(20 + degree)
    nb, n, k = 3, 16, (4 if degree == 3 else 2)
    base = [torch.from_numpy(_rand_limbs(rng, (nb, n))) for _ in range(k)]
    batch = [t.clone() for t in base]
    singles = [[t[b].clone() for t in base] for b in range(nb)]
    outs = [SK.sumcheck_round(batch, degree)]
    want = [[SK.sumcheck_round(s, degree)] for s in singles]
    active = n
    while active > 1:
        r = torch.from_numpy(_rand_limbs(rng, (nb,)))
        outs.append(SK.sumcheck_round(batch, degree, r, active // 2))
        for b, s in enumerate(singles):
            want[b].append(SK.sumcheck_round(s, degree, r[b], active // 2))
        active //= 2
    assert outs[-1] is None and all(w[-1] is None for w in want)
    for rnd, got in enumerate(outs[:-1]):
        assert tuple(got.shape) == (nb, 3 if degree == 3 else 2, 22)
        for b in range(nb):
            assert torch.equal(got[b], want[b][rnd])
    for q in range(k):
        for b in range(nb):
            assert torch.equal(batch[q][b, :1], singles[b][q][:1])
    with pytest.raises(ValueError):  # one challenge an instance, or one for all
        SK.sumcheck_round(batch, degree, torch.zeros(2, 22, dtype=torch.int32), 1)


# ---- the provers --------------------------------------------------------------

def test_prove_many_is_byte_equal_to_jax_and_verifies(insts, plain):
    jax_proofs, port_proofs = plain
    assert len(port_proofs) == len(insts)
    for inst, pj, pt in zip(insts, jax_proofs, port_proofs):
        assert TS.dumps(pt) == JS.dumps(pj)
        assert TS.dumps(pt) == TS.dumps(TN.prove(inst["dev_t"], inst["vars"], inst["inputs"]))
        assert TN.verify(inst["dev_t"], inst["inputs"], pt)
        assert JN.verify(inst["dev_j"], inst["inputs"], JS.loads(TS.dumps(pt)))


def test_prove_many_cross_instance_isolation(insts, plain):
    """A proof from the batch does not verify for another instance."""
    _, proofs = plain
    assert not TN.verify(insts[0]["dev_t"], insts[1]["inputs"], proofs[1])
    assert not TN.verify(insts[1]["dev_t"], insts[1]["inputs"], proofs[0])
    assert not JN.verify(insts[1]["dev_j"], insts[1]["inputs"], JS.loads(TS.dumps(proofs[0])))


def test_prove_many_zk_is_byte_equal_to_zknizk(insts, zk):
    for inst, seed, proof in zip(insts, ZK_SEEDS, zk):
        want = TZ.prove(inst["dev_t"], inst["vars"], inst["inputs"], seed=seed)
        assert TS.dumps(proof) == TS.dumps(want)
        assert TZ.verify(inst["dev_t"], inst["inputs"], proof)
    assert not TZ.verify(insts[0]["dev_t"], insts[2]["inputs"], zk[2])


def test_prove_many_zk_is_byte_equal_to_jax_zknizk(insts, zk):
    inst = insts[2]
    pj = JZ.prove(inst["dev_j"], inst["vars"], inst["inputs"], seed=ZK_SEEDS[2])
    assert TS.dumps(zk[2]) == JS.dumps(pj)
    assert JZ.verify(inst["dev_j"], inst["inputs"], JS.loads(TS.dumps(zk[2])))
    assert not JZ.verify(inst["dev_j"], insts[0]["inputs"], JS.loads(TS.dumps(zk[2])))


def test_a_batch_of_one_is_the_single_prover(insts):
    """hybrid.prove / prove_zk are batches of one: without the batch axis
    they give the host-transcript provers' bytes."""
    inst = insts[1]
    dev, v, i = inst["dev_t"], inst["vars"], inst["inputs"]
    assert TB.BatchedR1CS([dev]) is dev
    p = TH.prove(dev, v, i)
    assert TS.dumps(p) == TS.dumps(TN.prove(dev, v, i))
    assert TS.dumps(p) == TS.dumps(TB.prove_many([dev], [v], [i])[0])
    p = TH.prove_zk(dev, v, i, seed=ZK_SEEDS[0])
    assert TS.dumps(p) == TS.dumps(TZ.prove(dev, v, i, seed=ZK_SEEDS[0]))


def test_batched_r1cs_refuses_unequal_shapes(insts):
    bigger = _port_shape(insts[0]["shape_j"]).to_device("cpu", min_cons=64)
    with pytest.raises(ValueError, match="equal padded dimensions"):
        TB.BatchedR1CS([insts[1]["dev_t"], bigger])
