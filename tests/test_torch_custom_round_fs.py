"""Kernel K5's fused round (spartan/custom_kernels.py custom_round_fs: the
round and its transcript step) and what the redesigned kernel computes,
against the port's host Merlin, its torch DeviceTranscript and
otti_tpu.spartan.sumcheck.

* ``csrc/strobe.cuh`` compiled for the host (``csrc/host_check.cpp``): a
  round's transcript step at the post-challenge offsets under SPARK's
  labels (``spark/entry``, ``spark/row/table``, ``spark/col/table``) and
  random states, and at other offsets, equal to the host Merlin and the
  torch DeviceTranscript; the 64-byte reduction equal to
  ``bytes64_to_scalar_limbs``; the host's check of the step's offsets
  equal to the host Merlin's.
* The kernel's algebra: the combination's products summed over the pairs
  without the constants, then combined with them once a point, equal to
  ``custom_round_plain`` at every round of a whole sumcheck.
* ``custom_round_fs_plain`` chained through a whole sumcheck equal to the
  JAX package's and the port's ``prove_custom_device`` (at the shapes and
  the label of test_torch_custom_round.py, whose JAX programs that file
  compiles), and the argument checks.
* ``cuda`` cases: the fused kernel against its plain version (skipped
  without a card).

Tolerance: exact equality, this is modular arithmetic and byte strings.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.field.fields import SCALAR, ints_to_limbs
from otti_tpu.spartan import sumcheck as JSC
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.spartan import custom_kernels as CK
from otti_tpu_torch.spartan import spark as TSP  # noqa: F401  (registers the combinations)
from otti_tpu_torch.spartan import sumcheck as TSC
from otti_tpu_torch.transcript import device as TD
from otti_tpu_torch.transcript.merlin import transcript_from_strobe_state
from test_torch_custom_round import IDS, SHAPES, _case, _post_challenge
from test_torch_ristretto import host_encode  # noqa: F401  (csrc/host_check.cpp for the host)

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus
POST = TD.POST_CHALLENGE
SPARK_LABELS = [(b"spark/entry", 4), (b"spark/row/table", 3), (b"spark/col/table", 3)]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_round(lib, state: np.ndarray, offsets, labels, values: list):
    """strobe.cuh's merlin_round on the host -> (state, offsets, 64 bytes)."""
    st = state.copy()
    offs = np.array(offsets, np.int32)
    prog = np.frombuffer(CK.program_bytes(labels), np.uint8).copy()
    vals = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in values), np.uint8).copy()
    out = np.zeros(64, np.uint8)
    lib.otti_host_merlin_round(_ptr(st), _ptr(offs), _ptr(prog), _ptr(vals), _ptr(out))
    return st, tuple(int(o) for o in offs), out.tobytes()


def _merlin_round(state: np.ndarray, offsets, labels, values: list):
    """The same step by the host Merlin (pure-Python strobe)."""
    t = transcript_from_strobe_state(state.tobytes(), *offsets)
    for lbl, v in zip(labels, values):
        t.append_scalar(lbl, v.to_bytes(32, "little"))
    out = t.challenge_bytes(labels[-1], 64)
    s = t.strobe
    return np.frombuffer(bytes(s.state), np.uint8), (s.pos, s.pos_begin, s.cur_flags), out


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("label,degree", SPARK_LABELS, ids=[x[0].decode() for x in SPARK_LABELS])
def test_strobe_round_on_host_matches_merlin_and_device_transcript(host_encode, label, degree,
                                                                   seed):
    """A round's step at the post-challenge offsets: the state, the offsets
    (back where they started) and the 64 bytes from strobe.cuh equal the
    host Merlin's; the torch DeviceTranscript (custom_round_fs_plain's step)
    leaves the same state and draws the same challenge, which is the
    kernel's reduction of those bytes."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 256, 200, dtype=np.uint8)
    values = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(degree)]
    prog = CK.round_program(label, degree, "cpu")
    got = _host_round(host_encode, state, POST, prog.labels, values)
    want = _merlin_round(state, POST, prog.labels, values)
    assert got[0].tobytes() == want[0].tobytes() and got[1:] == want[1:]
    assert got[1] == POST
    st = torch.from_numpy(state.copy())
    t = TD.DeviceTranscript(_strobe=TD.DeviceStrobe(_raw=(st, *POST)))
    for lbl, v in zip(prog.labels, values):
        t.append_scalar_limbs(lbl, F.from_int(SCALAR, v))
    r = t.challenge_scalar_limbs(prog.labels[-1])
    assert st.numpy().tobytes() == want[0].tobytes() and t.strobe.offsets == POST
    assert F.to_int(SCALAR, r) == int.from_bytes(want[2], "little") % M
    limbs = np.zeros(22, np.int32)
    host_encode.otti_host_scalar_from_le64(_ptr(np.frombuffer(got[2], np.uint8).copy()),
                                           _ptr(limbs), ctypes.c_longlong(1))
    assert limbs.tolist() == r.tolist()


@pytest.mark.parametrize("offsets", [(0, 0, 0), (165, 100, 2), (130, 7, 18), (64, 0, 7)])
def test_strobe_round_on_host_at_other_offsets(host_encode, offsets):
    """The same program from offsets where the pad lands elsewhere (the
    rate fills inside a label, a length or a value): strobe.cuh == Merlin."""
    rng = np.random.default_rng(offsets[0])
    state = rng.integers(0, 256, 200, dtype=np.uint8)
    labels = (b"spark/row/table/e0", b"spark/row/table/e2", b"x" * 70, b"spark/row/table/r")
    values = [int.from_bytes(rng.bytes(32), "little") % M for _ in range(3)]
    got = _host_round(host_encode, state, offsets, labels, values)
    want = _merlin_round(state, offsets, labels, values)
    assert got[0].tobytes() == want[0].tobytes() and got[1:] == want[1:]


def test_step_offsets_match_a_strobe():
    """round_program accepts a state's offsets exactly when the step brings
    the host Merlin back to them: at the post-challenge offsets for SPARK's
    labels, and at random offsets only where the step returns there."""
    for label, degree in SPARK_LABELS:
        assert CK.round_program(label, degree, "cpu").offsets == POST
    rng = np.random.default_rng(7)
    for _ in range(40):
        label, degree = SPARK_LABELS[int(rng.integers(0, 3))]
        pos = int(rng.integers(0, 166))
        offsets = (pos, int(rng.integers(0, pos + 1)), int(rng.integers(0, 64)))
        labels = tuple(label + b"/e%d" % p for p in CK._eval_points(degree)) + (label + b"/r",)
        back = _merlin_round(np.zeros(200, np.uint8), offsets, labels, [0] * degree)[1] == offsets
        if back:
            assert CK.round_program(label, degree, "cpu", offsets=offsets).offsets == offsets
        else:
            with pytest.raises(ValueError, match="does not return"):
                CK.round_program(label, degree, "cpu", offsets=offsets)
    with pytest.raises(ValueError, match="does not return"):
        CK.round_program(b"spark/entry", 4, "cpu", offsets=(0, 0, 0))


def test_challenge_reduction_on_host_matches_plain(host_encode):
    """strobe.cuh's 64-byte reduction mod l against bytes64_to_scalar_limbs
    and Python integers: random bytes and the edges (0, 2^512 - 1, l,
    l 2^256, 2^256 - 1, 2^256)."""
    rng = np.random.default_rng(3)
    edges = [0, (1 << 512) - 1, M, M << 256, (1 << 256) - 1, 1 << 256]
    raw = [rng.bytes(64) for _ in range(50)] + [v.to_bytes(64, "little") for v in edges]
    b = np.frombuffer(b"".join(raw), np.uint8).reshape(-1, 64).copy()
    limbs = np.zeros((len(raw), 22), np.int32)
    host_encode.otti_host_scalar_from_le64(_ptr(b), _ptr(limbs), ctypes.c_longlong(len(raw)))
    plain = TD.bytes64_to_scalar_limbs(torch.from_numpy(b))
    assert np.array_equal(limbs, plain.numpy())
    assert F.to_ints(SCALAR, plain) == [int.from_bytes(x, "little") % M for x in raw]


def _hoisted_evals(stacked, half, consts, key, degree):
    """The round's evaluations as the redesigned kernel computes them: per
    point, the combination's products summed over the pairs without the
    constants (and spark_entry4's bare invr_t, invc_t), each sum mod l,
    then the constants once a point: S0 + c2 S1 + c3 S2 + c4 S3 + c5 S4,
    or c6 S0 + c7 S1."""
    mul = lambda a, b: F.mul(SCALAR, a, b)  # noqa: E731
    add = lambda a, b: F.add(SCALAR, a, b)  # noqa: E731
    lo, hi = stacked[:, :half], stacked[:, half:2 * half]
    d = F.sub(SCALAR, hi, lo)
    exts, cur = [lo], hi
    for _ in range(2, degree + 1):
        cur = F.add(SCALAR, cur, d)
        exts.append(cur)
    x = torch.stack(exts, dim=1).unbind(0)  # per table: [points, half, 22]
    one = F.ones(SCALAR, x[0].shape[:-1], x[0].device)
    minus_one = lambda a: F.sub(SCALAR, a, one)  # noqa: E731
    if key == "spark_entry4":
        sel, val, er, ec, eqn, invr, gr, invc, gc = x
        prods = [mul(mul(mul(sel, val), er), ec), mul(eqn, minus_one(mul(invr, gr))),
                 mul(eqn, minus_one(mul(invc, gc))), invr, invc]
    else:
        m, invt, eqx, gt = x
        prods = [mul(m, invt), mul(eqx, minus_one(mul(invt, gt)))]
    sums = [F.canon(SCALAR, F.sum_reduce(SCALAR, p, axis=1)) for p in prods]  # [points, 22]
    c = consts.unbind(0)
    if key == "spark_entry4":
        out = sums[0]
        for ci, si in zip(c, sums[1:]):
            out = add(out, mul(ci, si))
    else:
        out = add(mul(c[0], sums[0]), mul(c[1], sums[1]))
    return F.canon(SCALAR, out)


@pytest.mark.parametrize("key,degree,k,kc,n", SHAPES, ids=IDS)
def test_hoisted_constants_match_plain_round(key, degree, k, kc, n):
    """At every round of a whole sumcheck (semi-form tables, each round
    bound by custom_round_plain first): the kernel's split == the plain
    round's evaluations."""
    vals, cvals, rs = _case(key, degree, k, kc, n)
    stacked = torch.stack([F.from_ints(SCALAR, v) for v in vals])
    stacked[:, :, 0] += 4096  # semi form: the same values, limbs moved
    stacked[:, :, 1] -= 1
    consts = F.from_ints(SCALAR, cvals)
    ev = CK.custom_round_plain(stacked, consts, key, degree)
    assert torch.equal(_hoisted_evals(stacked, n // 2, consts, key, degree), ev)
    active, j = n, 1
    while active > 2:
        ev = CK.custom_round_plain(stacked, consts, key, degree, rs[j], active // 2)
        active //= 2
        j += 1
        assert torch.equal(_hoisted_evals(stacked, active // 2, consts, key, degree), ev)


@pytest.mark.parametrize("key,degree,k,kc,n", SHAPES, ids=IDS)
def test_fused_round_chain_matches_prove_custom_device(key, degree, k, kc, n):
    """custom_round_fs_plain round after round into preallocated buffers,
    then the bare final bind: the rounds' values and challenges, the final
    values and the transcript state equal the JAX package's and the port's
    prove_custom_device (whose host transcript replays the same rounds)."""
    vals, cvals, _ = _case(key, degree, k, kc, n)
    tables = tuple(F.from_ints(SCALAR, v) for v in vals)
    consts = tuple(F.from_int(SCALAR, c) for c in cvals)
    comb = CK._COMB_REGISTRY[key]
    claim = F.to_int(SCALAR, F.sum_reduce(SCALAR, comb(consts, tables), axis=0))
    (t_port, tj), (t_chain, _) = _post_challenge(), _post_challenge()
    want = JSC.prove_custom_device(
        claim, tuple(jnp.asarray(ints_to_limbs(v)) for v in vals),
        tuple(jnp.asarray(ints_to_limbs([c])[0]) for c in cvals), key, degree, tj, b"cs")
    port = TSC.prove_custom_device(claim, tables, consts, key, degree, t_port, b"cs")
    assert port == want

    stacked, cst = torch.stack(tables), torch.stack(consts)
    state = torch.from_numpy(TD.export_host_strobe(t_chain.strobe)[0])
    mu = n.bit_length() - 1
    prog = CK.round_program(b"cs", degree, "cpu")
    evals = torch.empty((mu, degree, 22), dtype=torch.int32)
    rs = torch.empty((mu, 22), dtype=torch.int32)
    for j in range(mu):
        prev = (rs[j - 1], n >> j) if j else (None, None)
        CK.custom_round_fs(stacked, cst, key, degree, state, prog, evals[j], rs[j], *prev)
    CK.custom_round(stacked, cst, key, degree, rs[mu - 1], 1)
    rounds, r_points, finals, _ = port
    assert [[r[0]] + r[2:] for r in rounds] == [F.to_ints(SCALAR, e) for e in evals]
    assert r_points == F.to_ints(SCALAR, rs)
    assert list(finals) == F.to_ints(SCALAR, stacked[:, 0])
    assert state.numpy().tobytes() == TD.export_host_strobe(t_port.strobe)[0].tobytes()


def _fs_args(n=8):
    stacked = torch.zeros((4, n, 22), dtype=torch.int32)
    return (stacked, torch.zeros((2, 22), dtype=torch.int32), "spark_table", 3,
            torch.zeros(200, dtype=torch.uint8), CK.round_program(b"cs", 3, "cpu"),
            torch.zeros((3, 22), dtype=torch.int32), torch.zeros(22, dtype=torch.int32))


@pytest.mark.parametrize("change,match", [
    pytest.param({4: torch.zeros(199, dtype=torch.uint8)}, "state must be", id="state shape"),
    pytest.param({6: torch.zeros((4, 22), dtype=torch.int32)}, "evals_out must be", id="evals"),
    pytest.param({7: torch.zeros(22, dtype=torch.int64)}, "r_out must be", id="challenge dtype"),
    pytest.param({5: CK.round_program(b"cs", 4, "cpu")}, "another degree", id="program degree"),
    pytest.param({"prev": (torch.zeros(22, dtype=torch.int32), 1)}, "bare final bind",
                 id="final bind"),
])
def test_custom_round_fs_argument_errors(change, match):
    args = list(_fs_args())
    for i, v in change.items():
        if i != "prev":
            args[i] = v
    prev = change.get("prev", (None, None))
    with pytest.raises(ValueError, match=match):
        CK.custom_round_fs(*args, *prev)


def test_custom_round_fs_device_errors():
    """No fallback: the kernel's wrapper refuses CPU tables, and a device
    with neither form raises."""
    with pytest.raises(ValueError, match="CUDA device"):
        CK.custom_round_fs_cuda(*_fs_args())
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in _fs_args()]
    with pytest.raises(ValueError, match="unsupported device"):
        CK.custom_round_fs(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("key,degree,k,kc,n", SHAPES, ids=IDS)
def test_fused_kernel_matches_plain_on_card(key, degree, k, kc, n):
    """The fused entry against custom_round_fs_plain round after round on
    the card: evaluations, challenge, transcript state and tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vals, cvals, _ = _case(key, degree, k, kc, n)
    base = torch.stack([F.from_ints(SCALAR, v) for v in vals]).cuda()
    consts = F.from_ints(SCALAR, cvals).cuda()
    state0 = torch.from_numpy(np.random.default_rng(n).integers(0, 256, 200, dtype=np.uint8))
    prog = CK.round_program(b"spark/entry", degree, "cuda")
    mu = n.bit_length() - 1
    out = {}
    for form, fn in (("kernel", CK.custom_round_fs_cuda), ("plain", CK.custom_round_fs_plain)):
        tabs, state = base.clone(), state0.cuda()
        evals = torch.empty((mu, degree, 22), dtype=torch.int32, device="cuda")
        rs = torch.empty((mu, 22), dtype=torch.int32, device="cuda")
        for j in range(mu):
            prev = (rs[j - 1], n >> j) if j else (None, None)
            fn(tabs, consts, key, degree, state, prog, evals[j], rs[j], *prev)
        out[form] = (evals, rs, state, tabs[:, :2])
    for a, b in zip(out["kernel"], out["plain"]):
        assert torch.equal(a, b)
