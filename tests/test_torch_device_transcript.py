"""The port's device transcript (otti_tpu_torch.transcript.device) against
otti_tpu.transcript.device and the port's host Merlin copy.

The same numpy-made states and messages go through the JAX package's
Keccak-f[1600], DeviceStrobe and DeviceTranscript, the port's (on the CPU:
the plain Keccak, torch ops on the state), and the host strobe; the state
bytes, the offsets and the challenges must be equal after every operation
kind (meta_ad, ad, prf, key, a handoff from a host transcript), and the
byte and scalar codecs must agree.  ``csrc/keccak.cuh`` compiled for the
host (the very permutation and pad the K3 kernel runs) is held against the
host library and the plain version at every pad those operations reach.
Tolerance: exact equality.  The K3 kernel itself is held against the plain
version by the ``cuda`` test (and by chip_smoke.py's device_fs phase on the
card).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.field import ops as JF
from otti_tpu.field.fields import SCALAR, int_to_limbs, ints_to_limbs, limbs_to_int
from otti_tpu.transcript import device as JD
from otti_tpu_torch import _build, native
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.transcript import device as TD
from otti_tpu_torch.transcript import keccak as t_keccak
from otti_tpu_torch.transcript.merlin import Strobe128, Transcript
from test_torch_ristretto import host_encode  # noqa: F401  (csrc/host_check.cpp for the host)

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus


def _states(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 200), dtype=np.uint8)


def test_keccak_plain_matches_jax_and_host():
    """Three seeded states, the zero state and a state permuted twice."""
    st = np.concatenate([_states(3, 1), np.zeros((1, 200), np.uint8)])
    got = TD.keccak_f1600_plain(torch.from_numpy(st)).numpy()
    jit = jax.jit(JD.keccak_f1600_bytes)
    for i in range(st.shape[0]):
        assert np.array_equal(got[i], np.asarray(jit(jnp.asarray(st[i]))))
        host = bytearray(st[i].tobytes())
        t_keccak.keccak_f1600(host)
        assert got[i].tobytes() == bytes(host)
    twice = TD.keccak_f1600_plain(TD.keccak_f1600_plain(torch.from_numpy(st[3:])))
    assert np.array_equal(twice.numpy()[0], np.asarray(jit(jit(jnp.asarray(st[3])))))
    # in place through the dispatching wrapper, one state or a batch
    one = torch.from_numpy(st[0].copy())
    assert TD.keccak_f1600_bytes(one) is one and np.array_equal(one.numpy(), got[0])


def test_keccak_kernel_constants_are_the_plain_versions(host_encode):
    """The tables compiled into csrc/keccak.cuh (the K3 kernel's): the 24
    round constants and the rho/pi gather's sources and rotations are the
    plain version's."""
    rc = np.zeros(24, np.uint64)
    src, rot = np.zeros(25, np.int32), np.zeros(25, np.int32)
    host_encode.otti_host_keccak_tables(
        *(a.ctypes.data_as(ctypes.c_void_p) for a in (rc, src, rot)))
    assert list(rc) == list(t_keccak._RC)
    assert np.array_equal(src, TD.PI_SRC) and np.array_equal(rot, TD.PI_ROT)
    assert sorted(TD.PI_SRC.tolist()) == list(range(25)) and TD.PI_ROT[0] == 0


def _same_strobe(t_strobe, j_strobe, h_strobe):
    state = t_strobe.state.numpy().tobytes()
    assert state == np.asarray(j_strobe.state).tobytes() == bytes(h_strobe.state)
    offsets = (h_strobe.pos, h_strobe.pos_begin, h_strobe.cur_flags)
    assert t_strobe.offsets == offsets == (j_strobe.pos, j_strobe.pos_begin, j_strobe.cur_flags)


OPS = ["meta_ad", "ad", "prf", "key", "rate_crossing"]


@pytest.mark.parametrize("op", OPS)
def test_strobe_state_after_each_op_kind(op):
    """A framed op of each kind, repeated, with messages that cross the
    166-byte rate; the state and offsets equal after every step."""
    label = b"port strobe test"
    t, j, h = TD.DeviceStrobe(label), JD.DeviceStrobe(label), Strobe128(label)
    _same_strobe(t, j, h)
    rng = np.random.default_rng(OPS.index(op))
    sizes = [3, 32, 64] if op != "rate_crossing" else [165, 1, 200, 166, 333]
    for i, n in enumerate(sizes):
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        more = i % 2 == 1 and op != "rate_crossing"
        if op in ("meta_ad", "ad", "key"):
            getattr(t, op)(torch.from_numpy(data.copy()), more)
            getattr(j, op)(jnp.asarray(data), more)
            getattr(h, op)(data.tobytes(), more)
        elif op == "prf":
            out_t, out_j, out_h = t.prf(n, more), j.prf(n, more), h.prf(n, more)
            assert out_t.numpy().tobytes() == np.asarray(out_j).tobytes() == out_h
        else:
            t.meta_ad(b"lbl", False)
            j.meta_ad(b"lbl", False)
            h.meta_ad(b"lbl", False)
            t.ad(torch.from_numpy(data.copy()), False)
            j.ad(jnp.asarray(data), False)
            h.ad(data.tobytes(), False)
            assert t.prf(64, False).numpy().tobytes() == h.prf(64, False)
            j.prf(64, False)
        _same_strobe(t, j, h)


@pytest.mark.parametrize("op", OPS)
def test_host_keccak_matches_native_and_plain(op, host_encode, monkeypatch):
    """keccak.cuh for the host, pad and permutation in one call as the K3
    kernel takes them, at every (pos, pos_begin) that this op kind's strobe
    sequence permutes at, and without a pad: equal to the host library and
    to the plain version on seeded states."""
    pads = []
    real = TD.keccak_f1600_bytes

    def recording(st, pos=-1, pos_begin=0):
        pads.append((pos, pos_begin))
        return real(st, pos, pos_begin)

    monkeypatch.setattr(TD, "keccak_f1600_bytes", recording)
    test_strobe_state_after_each_op_kind(op)
    assert all(0 <= pos <= TD._RATE for pos, _ in pads)  # none for meta_ad and ad alone
    st = _states(3, 20 + OPS.index(op))
    for pos, pos_begin in sorted(set(pads)) + [(-1, 0)]:
        got = st.copy()
        host_encode.otti_host_keccak_pad_f1600(got.ctypes.data_as(ctypes.c_void_p),
                                               ctypes.c_longlong(3), pos, pos_begin)
        plain = TD.keccak_f1600_plain(torch.from_numpy(st), pos, pos_begin).numpy()
        assert np.array_equal(got, plain), (pos, pos_begin)
        for i in range(3):
            want = bytearray(st[i].tobytes())
            if pos >= 0:
                want[pos] ^= pos_begin
                want[pos + 1] ^= 0x04
                want[TD._RATE + 1] ^= 0x80
            native.keccak_f1600(want)
            assert got[i].tobytes() == bytes(want), (pos, pos_begin, i)


def _scalar_limbs(x):
    return torch.from_numpy(np.asarray(int_to_limbs(x), np.int32))


@pytest.mark.parametrize("strobe", ["default", "python"])
def test_transcript_handoff_and_challenges(strobe, monkeypatch):
    """A host transcript (native C++ strobe or the Python one) handed to
    the device mid-protocol; appends of every kind and challenges, against
    the JAX package's DeviceTranscript and the host transcript itself."""
    from otti_tpu_torch.transcript import merlin as t_merlin

    if strobe == "python":
        monkeypatch.setattr(t_merlin, "_strobe_factory", lambda label: Strobe128(label))
    h = Transcript(b"handoff test")
    h.append_message(b"R1CS", b"\x01" * 32)
    h.append_u64(b"num_inputs", 3)
    st, pos, pos_begin, flags = TD.export_host_strobe(h.strobe)
    t = TD.DeviceTranscript.from_host(h, "cpu")
    j = JD.DeviceTranscript(_strobe=JD.DeviceStrobe.from_state(jnp.asarray(st), pos, pos_begin,
                                                               flags))
    assert t.export()[1:] == (pos, pos_begin, flags)
    rng = np.random.default_rng(7)
    vals = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(4)] + [0, M - 1]
    for i, v in enumerate(vals):
        enc = rng.bytes(32)
        h.append_point(b"poly_commitment", enc)
        t.append_point_bytes(b"poly_commitment", torch.frombuffer(bytearray(enc), dtype=torch.uint8))
        j.append_point_bytes(b"poly_commitment", jnp.asarray(np.frombuffer(enc, np.uint8)))
        h.append_scalar(b"e0", v.to_bytes(32, "little"))
        t.append_scalar_limbs(b"e0", _scalar_limbs(v))
        j.append_scalar_limbs(b"e0", jnp.asarray(int_to_limbs(v)))
        if i % 2:
            h.append_u64(b"u", i)
            t.append_u64(b"u", i)
            j.append_u64(b"u", i)
        want = h.challenge_scalar(b"r")
        got = t.challenge_scalar_limbs(b"r")
        assert F.to_int(SCALAR, got) == want
        assert got.numpy().max() < 4096 and got.numpy().min() >= 0  # canonical limbs
        assert limbs_to_int(np.asarray(JF.canon(SCALAR, j.challenge_scalar_limbs(b"r")))) == want
    tau_h = h.challenge_vector(b"challenge_tau", 3)
    tau_t = t.challenge_vector_limbs(b"challenge_tau", 3)
    j.challenge_vector_limbs(b"challenge_tau", 3)
    assert F.to_ints(SCALAR, tau_t) == tau_h
    state, *offsets = t.export()
    assert state.numpy().tobytes() == np.asarray(j.export()[0]).tobytes()
    assert tuple(offsets) == j.export()[1:] == tuple(TD.export_host_strobe(h.strobe)[1:])
    assert tuple(offsets) == (64, 0, TD.FLAG_I | TD.FLAG_A | TD.FLAG_C)  # post-challenge
    # a fresh device transcript equals a fresh host one
    fresh_t, fresh_h = TD.DeviceTranscript(b"fresh"), Transcript(b"fresh")
    assert fresh_t.export()[0].numpy().tobytes() == TD.export_host_strobe(fresh_h.strobe)[0].tobytes()


def test_scalar_codecs_match_jax():
    rng = np.random.default_rng(3)
    vals = [0, 1, M - 1] + [int.from_bytes(rng.bytes(32), "little") % M for _ in range(20)]
    limbs = ints_to_limbs(vals).astype(np.int32)
    got = TD.limbs_to_bytes32(torch.from_numpy(limbs))
    assert got.dtype == torch.uint8
    want = np.stack([np.asarray(JD.limbs_to_bytes32(jnp.asarray(row))) for row in limbs])
    assert np.array_equal(got.numpy(), want)
    assert [bytes(r) for r in got.numpy()] == [v.to_bytes(32, "little") for v in vals]
    wide = rng.integers(0, 256, size=(6, 64), dtype=np.uint8)
    wide[0] = 255
    red = TD.bytes64_to_scalar_limbs(torch.from_numpy(wide))
    want = [limbs_to_int(np.asarray(JF.canon(SCALAR, JD.bytes64_to_scalar_limbs(jnp.asarray(w)))))
            for w in wide]
    assert F.to_ints(SCALAR, red) == want == [int.from_bytes(w.tobytes(), "little") % M
                                              for w in wide]
    assert red.numpy().max() < 4096  # canonical, as kernel 2 and the absorbs take it


def test_keccak_kernel_wrapper_refuses_cpu_tensors():
    st = torch.zeros((1, 200), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TD.keccak_f1600_cuda(st)
    assert _build.LAUNCHES["keccak_f1600"] == 0


@pytest.mark.cuda
def test_keccak_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st = torch.from_numpy(_states(257, 5)).cuda()
    before = _build.LAUNCHES["keccak_f1600"]
    got = TD.keccak_f1600_cuda(st.clone())
    assert _build.LAUNCHES["keccak_f1600"] == before + 1
    assert torch.equal(got, TD.keccak_f1600_plain(st))
    padded = TD.keccak_f1600_cuda(st.clone(), 166, 9)
    assert _build.LAUNCHES["keccak_f1600"] == before + 2
    assert torch.equal(padded, TD.keccak_f1600_plain(st, 166, 9))
    with pytest.raises(ValueError):  # permuted in place: a misaligned view is refused
        TD.keccak_f1600_cuda(
            torch.zeros(1608, dtype=torch.uint8, device="cuda")[4:1604].view(8, 200))
    t = TD.DeviceTranscript(b"card", "cuda")
    h = Transcript(b"card")
    for i in range(5):
        t.append_message(b"m", bytes([i]) * 100)
        h.append_message(b"m", bytes([i]) * 100)
        assert F.to_int(SCALAR, t.challenge_scalar_limbs(b"c")) == h.challenge_scalar(b"c")
