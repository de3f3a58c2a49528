"""The port's own copies of the host-only modules against their originals.

``otti_tpu_torch`` imports nothing of ``otti_tpu``: it carries copies of the
field constants, the reference curve arithmetic, Keccak and Merlin, the
native host binding, the PMLB loader and the SGD oracle.  Each copy is held
against its original on the same seeded inputs.  Tolerance: exact equality.
"""

import numpy as np
import pytest

from otti_tpu import native as j_native
from otti_tpu.field import fields as j_fields
from otti_tpu.io import pmlb_local as j_pmlb
from otti_tpu.oracle import sgd_oracle as j_oracle
from otti_tpu.refimpl import numeric as j_ref
from otti_tpu.transcript import keccak as j_keccak
from otti_tpu.transcript import merlin as j_merlin
from otti_tpu_torch import metrics as t_metrics
from otti_tpu_torch import native as t_native
from otti_tpu_torch.field import fields as t_fields
from otti_tpu_torch.io import pmlb_local as t_pmlb
from otti_tpu_torch.oracle import sgd_oracle as t_oracle
from otti_tpu_torch.refimpl import numeric as t_ref
from otti_tpu_torch.transcript import keccak as t_keccak
from otti_tpu_torch.transcript import merlin as t_merlin


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", ["SCALAR", "BASE"])
def test_field_spec_constants_equal(name):
    a, b = getattr(t_fields, name), getattr(j_fields, name)
    assert sorted(vars(a)) == sorted(vars(b))
    for key, value in vars(b).items():
        assert _same(getattr(a, key), value), key
    for const in ("LIMB_BITS", "N_LIMBS", "LIMB_MASK", "CONV_LIMBS", "FOLD_LIMB",
                  "P25519", "L25519", "SCALAR_TAIL"):
        assert getattr(t_fields, const) == getattr(j_fields, const)


def test_field_codecs_equal():
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(40)]
    assert np.array_equal(t_fields.ints_to_limbs(vals), j_fields.ints_to_limbs(vals))
    assert np.array_equal(t_fields.ints_to_limbs(vals[:3]), j_fields.ints_to_limbs(vals[:3]))
    limbs = t_fields.ints_to_limbs(vals)
    assert t_fields.limbs_to_ints(limbs) == j_fields.limbs_to_ints(limbs) == vals
    assert np.array_equal(t_fields.int_to_limbs(vals[0]), j_fields.int_to_limbs(vals[0]))


@pytest.mark.parametrize("fn", ["keccak_f1600", "shake256", "sha3_256", "sha3_512"])
def test_keccak_equal(fn):
    rng = np.random.default_rng(2)
    for size in (0, 1, 135, 136, 137, 500):
        data = rng.bytes(size)
        if fn == "keccak_f1600":
            sa = bytearray(rng.bytes(200))
            sb = bytearray(sa)
            t_keccak.keccak_f1600(sa)
            j_keccak.keccak_f1600(sb)
            assert sa == sb
        elif fn == "shake256":
            assert t_keccak.shake256(data, 77) == j_keccak.shake256(data, 77)
        else:
            assert getattr(t_keccak, fn)(data) == getattr(j_keccak, fn)(data)


@pytest.mark.parametrize("strobe", ["default", "python"])
def test_merlin_transcript_equal(strobe, monkeypatch):
    """Labels, messages, a u64, a scalar and challenges, through whichever
    STROBE each package loaded and through both pure-Python ones."""
    if strobe == "python":
        monkeypatch.setattr(t_merlin, "_strobe_factory", t_merlin.Strobe128)
        monkeypatch.setattr(j_merlin, "_strobe_factory", j_merlin.Strobe128)
    outs = []
    for mod in (t_merlin, j_merlin):
        r = np.random.default_rng(3)
        t = mod.Transcript(b"copy test")
        t.append_protocol_name(b"proto")
        t.append_message(b"msg", r.bytes(300))
        t.append_u64(b"n", 1 << 40)
        t.append_scalar(b"s", r.bytes(32))
        t.append_point(b"p", r.bytes(32))
        outs.append((t.challenge_bytes(b"c", 64), t.challenge_scalar(b"x"),
                     t.challenge_vector(b"v", 3), t.challenge_scalar_bytes(b"y")))
    assert outs[0] == outs[1]


def _points(mod, n, seed):
    rng = np.random.default_rng(seed)
    return [mod.EdPoint.from_uniform_bytes(rng.bytes(64)) for _ in range(n)]


def _coords(p):
    return p.affine()


@pytest.mark.parametrize("op", ["add", "double", "scalar_mul", "neg", "encode", "decode"])
def test_numeric_curve_ops_equal(op):
    pa, pb = _points(t_ref, 4, 4), _points(j_ref, 4, 4)
    k = 0x1234567890ABCDEF1234567890ABCDEF1234567 % t_ref.L
    for i in range(4):
        a, a2, b, b2 = pa[i], pa[(i + 1) % 4], pb[i], pb[(i + 1) % 4]
        if op == "add":
            assert _coords(a + a2) == _coords(b + b2)
        elif op == "double":
            assert _coords(a.double()) == _coords(b.double())
        elif op == "scalar_mul":
            assert _coords(a * k) == _coords(b * k)
        elif op == "neg":
            assert _coords(-a) == _coords(-b)
        elif op == "encode":
            assert a.ristretto_encode() == b.ristretto_encode()
        else:
            enc = a.ristretto_encode()
            assert t_ref.EdPoint.ristretto_decode(enc).ristretto_encode() == enc
            assert j_ref.EdPoint.ristretto_decode(enc).ristretto_encode() == enc
    for const in ("P", "L", "D", "SQRT_M1"):
        assert getattr(t_ref, const) == getattr(j_ref, const)
    wide = np.random.default_rng(5).bytes(64)
    assert t_ref.scalar_from_bytes_mod_order_wide(wide) == j_ref.scalar_from_bytes_mod_order_wide(wide)


@pytest.fixture(scope="module")
def iris():
    return t_pmlb.fetch("iris", 0, 1, seed=3), j_pmlb.fetch("iris", 0, 1, seed=3)


def test_pmlb_fetch_equal(iris):
    (Xa, ya, sa), (Xb, yb, sb) = iris
    assert sa == sb == "pmlb_cache"
    assert _same(Xa, Xb) and _same(ya, yb)
    Xs, ys = t_pmlb.synthesize("no_such_dataset", 0, 1, seed=9)[:2]
    Xr, yr = j_pmlb.synthesize("no_such_dataset", 0, 1, seed=9)[:2]
    assert _same(Xs, Xr) and _same(ys, yr)


def test_sgd_oracle_weights_equal(iris):
    (X, y, _), _ = iris
    assert _same(np.asarray(t_oracle.solve(X, y, seed=3)), np.asarray(j_oracle.solve(X, y, seed=3)))
    assert _same(np.asarray(t_oracle._perceptron_int(X, y)), np.asarray(j_oracle._perceptron_int(X, y)))


@pytest.mark.parametrize("fn", ["msm_host", "ristretto_encode_host", "ristretto_decode_host",
                                "fold_pairs_host", "scalar_mul_host"])
def test_native_host_ops_equal(fn):
    """The port's binding (its own build of native/otti_host.cpp) against
    the JAX package's, and both against the pure-Python reference."""
    assert t_native.HAVE_NATIVE == j_native.HAVE_NATIVE
    rng = np.random.default_rng(6)
    pa, pb = _points(t_ref, 6, 7), _points(j_ref, 6, 7)
    ks = [int.from_bytes(rng.bytes(32), "little") % t_ref.L for _ in range(6)]
    if fn == "msm_host":
        got, want = t_native.msm_host(pa, ks), j_native.msm_host(pb, ks)
        acc = t_ref.EdPoint.identity()
        for k, p in zip(ks, pa):
            acc = acc + p * k
        assert _coords(got) == _coords(want) == _coords(acc)
    elif fn == "ristretto_encode_host":
        enc = [t_native.ristretto_encode_host(p) for p in pa]
        assert enc == [j_native.ristretto_encode_host(p) for p in pb]
        assert enc == [p.ristretto_encode() for p in pa]
    elif fn == "ristretto_decode_host":
        for p in pa:
            enc = p.ristretto_encode()
            assert t_native.ristretto_decode_host(enc).ristretto_encode() == enc
            assert j_native.ristretto_decode_host(enc).ristretto_encode() == enc
        assert t_native.ristretto_decode_host(b"\xff" * 32) is None
    elif fn == "fold_pairs_host":
        got = t_native.fold_pairs_host(pa[:3], pa[3:], ks[0], ks[1])
        want = j_native.fold_pairs_host(pb[:3], pb[3:], ks[0], ks[1])
        assert [_coords(p) for p in got] == [_coords(p) for p in want]
        assert _coords(got[0]) == _coords(pa[0] * ks[0] + pa[3] * ks[1])
    else:
        assert _coords(t_native.scalar_mul_host(pa[0], ks[2])) == _coords(
            j_native.scalar_mul_host(pb[0], ks[2])) == _coords(pa[0] * ks[2])


def test_native_keccak_and_strobe_equal():
    if not t_native.HAVE_NATIVE:
        pytest.skip("no C++ compiler: both packages use the Python transcript")
    state = bytearray(np.random.default_rng(8).bytes(200))
    sa, sb = bytearray(state), bytearray(state)
    t_native.keccak_f1600(sa)
    j_keccak.keccak_f1600(sb)
    assert sa == sb
    a, b = t_native.NativeStrobe(b"x"), j_merlin.Strobe128(b"x")
    for s in (a, b):
        s.meta_ad(b"label", False)
        s.ad(b"data" * 50, False)
    assert a.prf(48, False) == b.prf(48, False)


def test_metrics_counters_and_timer():
    t_metrics.reset()
    t_metrics.add("rounds", 3)
    t_metrics.add("rounds")
    with t_metrics.timed("stage"):
        pass
    snap = t_metrics.snapshot()
    assert snap["rounds"] == 4.0 and snap["stage_s"] >= 0.0
    assert not hasattr(t_metrics, "profile_trace")
    t_metrics.reset()
    assert t_metrics.snapshot() == {}
