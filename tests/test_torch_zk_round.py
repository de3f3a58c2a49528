"""Kernel K6 (spartan/zk_round_kernel.py, csrc/zk_round.cu): a zero-knowledge
sumcheck round after its evaluations in one launch, against the torch round
it replaces (spartan/zkfused.py ``_zk_round_plain``).

* ``csrc/zk_round.cuh`` compiled for the host (``csrc/host_check.cpp``): the
  round one block of the kernel runs, at degree 2 and 3, with random and
  with zero blinds, and per instance of a batch of two, equal to the torch
  round byte for byte: e_next (canonical), r, the four encodings, z, zdb and
  the sponge state after the round.
* The dispatcher: CPU tensors take the torch round, no K6 launch; the
  host's check of the round's offsets.
* ``cuda`` cases (skipped without a card): K6 against the torch round on the
  card at degree 2 and 3, one instance and a batch of 8, random and zero
  blinds; a whole ``_zk_round_scan`` over 2^10 tables; a whole proof by
  ``hybrid_sharded.prove_zk`` at k = 2 on one card (its local rounds and its
  scan) with K6 and with the torch round.

Imports nothing of the JAX package, so the card can run it
(``python -m pytest --noconftest tests/test_torch_zk_round.py``).  Tolerance:
exact equality, this is modular arithmetic and byte strings.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from otti_tpu_torch import _build
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.field.fields import SCALAR
from otti_tpu_torch.spartan import zk_round_kernel as ZR
from otti_tpu_torch.spartan import zkfused as ZF
from otti_tpu_torch.transcript import device as TD

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus
LABELS = {3: b"sc1", 2: b"sc2"}


def _scalars(rng, shape) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    vals = [int.from_bytes(rng.bytes(32), "little") % M for _ in range(n)]
    return F.from_ints(SCALAR, vals).reshape(tuple(shape) + (22,))


def _semi(x: torch.Tensor, rng) -> torch.Tensor:
    """The same values in non-canonical limbs: one unit of 2^12 moved down
    one limb (a limb above 2^12, and -1 where a limb was 0)."""
    x = x.clone()
    flat = x.view(-1, 22)
    for row in flat:
        p = int(rng.integers(1, 22))
        row[p] -= 1
        row[p - 1] += 4096
    return x


def _round_inputs(degree: int, batch: int, zero: bool, seed: int):
    """(e, be, evs, xs, state) of one round on the CPU; ``batch`` 0: no
    leading axis.  ``zero``: every blind and the running claim zero, as in
    a phase's first round with blinds drawn as zero."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    evs = _scalars(rng, lead + (degree,))
    if zero:
        e, be = F.zeros(lead), F.zeros(lead)
        xs = (F.zeros(lead), F.zeros(lead), F.zeros(lead + (degree + 1,)), F.zeros(lead),
              F.zeros(lead))
    else:
        e, be = _semi(_scalars(rng, lead), rng), _semi(_scalars(rng, lead), rng)
        xs = (_scalars(rng, lead), _scalars(rng, lead), _scalars(rng, lead + (degree + 1,)),
              _scalars(rng, lead), _scalars(rng, lead))
    state = torch.from_numpy(rng.integers(0, 256, lead + (200,), dtype=np.uint8))
    return e, be, evs, xs, state


def _transcript(state: torch.Tensor) -> TD.DeviceTranscript:
    return TD.DeviceTranscript(_strobe=TD.DeviceStrobe(_raw=(state, *TD.POST_CHALLENGE)))


def _plain(degree, e, be, evs, xs, state, device="cpu"):
    """The torch round on ``device`` -> (e_next canonical, r, encs, z, zdb,
    state) on the host."""
    to = lambda x: x.to(device)  # noqa: E731
    t = _transcript(to(state).clone())
    out = ZF._zk_round_plain(LABELS[degree], degree, ZF._round_tables(degree, device), t,
                             to(e), to(be), to(evs), tuple(map(to, xs)))
    assert t.strobe.offsets == TD.POST_CHALLENGE
    e_next, _, r, encs, z, zdb = out
    return tuple(x.cpu() for x in (F.canon(SCALAR, e_next), r, encs, z, zdb, t.strobe.state))


def _equal(got: tuple, want: tuple) -> None:
    for name, g, w in zip(("e_next", "r", "encs", "z", "zdb", "state"), got, want):
        assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the round compiled for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_round(tmp_path_factory):
    """csrc/zk_round.cuh on the headers it includes, compiled for the host
    (csrc/host_check.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("host_zk_round") / "libotti_host_check.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    os.path.join(_build.CSRC_DIR, "host_check.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.otti_host_set_zk_round_consts(_build.zk_round_consts().ctypes.data_as(ctypes.c_void_p))
    return lib


def _host(lib, degree, e, be, evs, xs, state):
    """csrc/zk_round.cuh's round on the host for one instance -> what
    ``_plain`` returns."""
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    rows = [np.ascontiguousarray(x.numpy(), np.int32) for x in (evs, e, be, *xs)]
    ins = (ctypes.c_void_p * 8)(*(r.ctypes.data for r in rows))
    vinv = np.ascontiguousarray(ZF._vandermonde_inv_limbs(degree, "cpu").numpy())
    table = np.ascontiguousarray(ZF._round_tables(degree, "cpu")["p"].numpy())
    prog = ZR.round_program(LABELS[degree], degree, "cpu").numpy()
    st = state.numpy().copy()
    offs = np.array(TD.POST_CHALLENGE, np.int32)
    outs = [np.zeros(s, np.int32) for s in ((22,), (22,), (degree + 1, 22), (2, 22))]
    encs = np.zeros((4, 32), np.uint8)
    e_next, r, z, zdb = outs
    rc = lib.otti_host_zk_round(ins, ptr(vinv), ptr(table), ptr(prog), ptr(st), ptr(offs),
                                ptr(e_next), ptr(r), ptr(encs), ptr(z), ptr(zdb),
                                ctypes.c_int(degree))
    assert rc == 0
    return tuple(torch.from_numpy(x) for x in (e_next, r, encs, z, zdb, st))


@pytest.mark.parametrize("zero", [False, True], ids=["random", "zero-blinds"])
@pytest.mark.parametrize("degree", [2, 3])
def test_host_round_equals_torch_round(host_round, degree, zero):
    """The kernel's round, compiled for the host, on semi-form claims (or
    zero claims and blinds) equals the torch round byte for byte."""
    e, be, evs, xs, state = _round_inputs(degree, 0, zero, seed=10 * degree + zero)
    want = _plain(degree, e, be, evs, xs, state)
    _equal(_host(host_round, degree, e, be, evs, xs, state), want)
    if zero:  # delta commits to zero: the identity, encoded as 32 zero bytes
        assert not want[2][2].any()


def test_host_round_equals_batched_torch_round(host_round):
    """A batch of two through the torch round (one MSM a commitment kind for
    both) equals the host round of each instance."""
    degree = 3
    e, be, evs, xs, state = _round_inputs(degree, 2, False, seed=7)
    want = _plain(degree, e, be, evs, xs, state)
    for b in range(2):
        got = _host(host_round, degree, e[b], be[b], evs[b], tuple(x[b] for x in xs), state[b])
        _equal(got, tuple(w[b] for w in want))


def test_cpu_tensors_take_the_torch_round():
    """_zk_round_from_evals on CPU tensors is the torch round, and no K6
    launch is counted."""
    degree = 2
    e, be, evs, xs, state = _round_inputs(degree, 0, False, seed=3)
    before = _build.LAUNCHES["zk_round"]
    t = _transcript(state.clone())
    out = ZF._zk_round_from_evals(LABELS[degree], degree, ZF._round_tables(degree, "cpu"), t,
                                  e, be, evs, xs)
    assert _build.LAUNCHES["zk_round"] == before == 0
    e_next, b_next, r, encs, z, zdb = out
    assert b_next is xs[1]
    _equal((F.canon(SCALAR, e_next), r, encs, z, zdb, t.strobe.state),
           _plain(degree, e, be, evs, xs, state))


def test_round_program_offsets():
    """The program's labels in the kernel's order; a round returns to the
    post-challenge offsets, and from other offsets it would not return."""
    labels = ZR.round_labels(b"sc1")
    assert len(labels) == 13 and labels[6] == b"dot product proof"
    buf = ZR.round_program(b"sc1", 3, "cpu")
    assert buf.numpy().tobytes()[:14] == bytes([13]) + bytes(len(lb) for lb in labels)
    for degree in (2, 3):
        assert ZR.step_offsets(b"sc2", degree, TD.POST_CHALLENGE) == TD.POST_CHALLENGE
    other = (10, 0, TD.FLAG_A)
    assert ZR.step_offsets(b"sc1", 3, other) != other


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _kernel(degree, e, be, evs, xs, state, device):
    to = lambda x: x.to(device)  # noqa: E731
    t = _transcript(to(state).clone())
    before = _build.LAUNCHES["zk_round"]
    out = ZF._zk_round_from_evals(LABELS[degree], degree, ZF._round_tables(degree, device), t,
                                  to(e), to(be), to(evs), tuple(map(to, xs)))
    assert _build.LAUNCHES["zk_round"] == before + 1
    e_next, _, r, encs, z, zdb = out
    return tuple(x.cpu() for x in (e_next, r, encs, z, zdb, t.strobe.state))


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [False, True], ids=["random", "zero-blinds"])
@pytest.mark.parametrize("batch", [0, 8], ids=["B1", "B8"])
@pytest.mark.parametrize("degree", [2, 3])
def test_kernel_round_equals_torch_round(degree, batch, zero):
    card = _card()
    e, be, evs, xs, state = _round_inputs(degree, batch, zero, seed=100 + 10 * degree + zero)
    _equal(_kernel(degree, e, be, evs, xs, state, card),
           _plain(degree, e, be, evs, xs, state, card))


def _scan(degree, tables, blinds, device, kernel: bool, monkeypatch):
    with monkeypatch.context() as m:
        if not kernel:
            m.setattr(ZF, "_zk_round_from_evals", ZF._zk_round_plain)
        tabs = [tb.to(device).clone() for tb in tables]
        t = _transcript(torch.arange(200, dtype=torch.uint8).to(device))
        zero = F.zeros((), device)
        out = ZF._zk_round_scan(t, LABELS[degree], degree, ZF._round_tables(degree, device),
                                tabs, tuple(b.to(device) for b in blinds), zero, zero)
        e, be, encs, z, zdb, rs = out
        return [x.cpu() for x in (F.canon(SCALAR, e), be, encs, z, zdb, rs, t.strobe.state,
                                  *tabs)]


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [2, 3])
def test_kernel_scan_over_2_10_tables(degree, monkeypatch):
    """A whole zk sumcheck phase over 2^10-row tables: kernel 2 and K6 a
    round against kernel 2 and the torch round."""
    card = _card()
    rng = np.random.default_rng(degree)
    n, mu = 1 << 10, 10
    tables = [_scalars(rng, (n,)) for _ in range(degree + 1 if degree == 3 else 2)]
    blinds = (_scalars(rng, (mu,)), _scalars(rng, (mu,)), _scalars(rng, (mu, degree + 1)),
              _scalars(rng, (mu,)), _scalars(rng, (mu,)))
    before = _build.LAUNCHES["zk_round"]
    got = _scan(degree, tables, blinds, card, True, monkeypatch)
    assert _build.LAUNCHES["zk_round"] == before + mu
    want = _scan(degree, tables, blinds, card, False, monkeypatch)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


def _instance(num_vars: int = 24, seed: int = 5):
    """A satisfied R1CS without the JAX package: products of random
    witness values and one public input, (shape, vars, inputs)."""
    from otti_tpu_torch.spartan import r1cs as TR

    rng = np.random.default_rng(seed)
    base = num_vars // 2
    vals = [int(rng.integers(1, 1 << 30)) for _ in range(base)]
    A, B, C = [], [], []
    for j in range(num_vars - base):
        i1, i2 = int(rng.integers(0, base)), int(rng.integers(0, base))
        vals.append(vals[i1] * vals[i2] % M)
        A.append((j, i1, 1))
        B.append((j, i2, 1))
        C.append((j, base + j, 1))
    row = num_vars - base  # input * 1 = vars[0]
    A.append((row, num_vars + 1, 1))
    B.append((row, num_vars, 1))
    C.append((row, 0, 1))
    shape = TR.R1CSShape.from_logical(row + 1, num_vars, 1, A, B, C)
    return shape, vals, [vals[0]]


@pytest.mark.cuda
def test_kernel_in_sharded_prove_zk_k2(monkeypatch):
    """hybrid_sharded.prove_zk over 2 shards on one card (local rounds, then
    the scan): the same bytes with K6 as with the torch round."""
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.spartan import serial as TS

    card = _card()
    shape, vals, inputs = _instance()
    dev = shape.to_device(card)
    seed = b"k6 sharded round" + bytes(16)
    before = _build.LAUNCHES["zk_round"]
    got = TS.dumps(HS.prove_zk(dev, vals, inputs, k=2, seed=seed, devices=[card, card]))
    mu_x = (dev.num_cons - 1).bit_length()
    mu_y = (dev.num_z - 1).bit_length()
    assert _build.LAUNCHES["zk_round"] - before == mu_x + mu_y
    with monkeypatch.context() as m:
        m.setattr(ZF, "_zk_round_from_evals", ZF._zk_round_plain)
        want = TS.dumps(HS.prove_zk(dev, vals, inputs, k=2, seed=seed, devices=[card, card]))
    assert got == want
