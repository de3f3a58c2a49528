"""The port's own copies of the host-only modules against their originals.

``otti_tpu_torch`` imports nothing of ``otti_tpu``: it carries copies of the
field constants, the reference curve arithmetic, Keccak and Merlin, the
native host binding, the PMLB loader, the SGD oracle, and the host side of
the zero-knowledge layer (Pedersen commitments, sigma proofs, wire
profiles).  Each copy is held against its original on the same seeded
inputs.  Tolerance: exact equality.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from otti_tpu import native as j_native
from otti_tpu.field import fields as j_fields
from otti_tpu.io import pmlb_local as j_pmlb
from otti_tpu.oracle import sgd_oracle as j_oracle
from otti_tpu.refimpl import numeric as j_ref
from otti_tpu.spartan import pedersen_host as j_ped
from otti_tpu.spartan import sigma as j_sigma
from otti_tpu.spartan import wire as j_wire
from otti_tpu.transcript import keccak as j_keccak
from otti_tpu.transcript import merlin as j_merlin
from otti_tpu_torch import metrics as t_metrics
from otti_tpu_torch import native as t_native
from otti_tpu_torch.field import fields as t_fields
from otti_tpu_torch.io import pmlb_local as t_pmlb
from otti_tpu_torch.oracle import sgd_oracle as t_oracle
from otti_tpu_torch.refimpl import numeric as t_ref
from otti_tpu_torch.spartan import pedersen_host as t_ped
from otti_tpu_torch.spartan import sigma as t_sigma
from otti_tpu_torch.spartan import wire as t_wire
from otti_tpu_torch.transcript import keccak as t_keccak
from otti_tpu_torch.transcript import merlin as t_merlin

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each


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


# ---- the host side of the zero-knowledge layer ----------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["pedersen_host", "sigma", "wire"])
def test_zk_host_module_is_a_marked_copy(name):
    """The copy is its original under one marking line.  Its imports are
    relative, so they are the same text and reach the port's own modules."""
    with open(os.path.join(REPO, "otti_tpu", "spartan", name + ".py")) as f:
        original = f.read()
    with open(os.path.join(REPO, "otti_tpu_torch", "spartan", name + ".py")) as f:
        marker, copy = f.readline(), f.read()
    assert marker == f"# copied from otti_tpu/spartan/{name}.py\n"
    assert copy == original
    mod = {"pedersen_host": t_ped, "sigma": t_sigma, "wire": t_wire}[name]
    for value in vars(mod).values():
        owner = getattr(value, "__module__", None) or ""
        assert not owner.startswith("otti_tpu."), (name, value)


def test_blind_source_gives_the_same_stream():
    seed = np.random.default_rng(10).bytes(32)
    a, b = t_ped.BlindSource(seed), j_ped.BlindSource(seed)
    assert a.scalars(5) + [a.scalar()] == b.scalars(5) + [b.scalar()]
    assert a.ctr == b.ctr == 6
    assert t_ped.BlindSource(b"\x00" * 32).scalar() != t_ped.BlindSource(seed).scalar()


def test_pedersen_commitments_equal():
    vals = [int.from_bytes(np.random.default_rng(11).bytes(40), "little") for _ in range(5)]
    ga, gb = t_ped.Gens(4, b"copy gens"), j_ped.Gens(4, b"copy gens")
    assert t_ped.commit(vals[0], vals[1], ga).ristretto_encode() \
        == j_ped.commit(vals[0], vals[1], gb).ristretto_encode()
    assert t_ped.commit_vec(vals[:3], vals[4], ga.sub(3)).ristretto_encode() \
        == j_ped.commit_vec(vals[:3], vals[4], gb.sub(3)).ristretto_encode()
    enc = t_ped.commit(1, 2, ga).ristretto_encode()
    assert t_ped.decode(enc).ristretto_encode() == j_ped.decode(enc).ristretto_encode() == enc
    with pytest.raises(ValueError):
        t_ped.decode(b"\xff" * 32)


def test_wire_profiles_equal():
    assert sorted(t_wire.PROFILES) == sorted(j_wire.PROFILES) == ["otti", "spartan"]
    for name in t_wire.PROFILES:
        assert dataclasses.asdict(t_wire.PROFILES[name]) == dataclasses.asdict(j_wire.PROFILES[name])
    for mod, merlin in ((t_wire, t_merlin), (j_wire, j_merlin)):
        assert mod.OTTI.rl(b"sc1", b"r") == b"sc1/r" and mod.SPARTAN.rl(b"sc1", b"r") == b"r"
    draws = [[mod.PROFILES[n].draw_weights(merlin.Transcript(b"w"), b"sc")
              for n in ("otti", "spartan")]
             for mod, merlin in ((t_wire, t_merlin), (j_wire, j_merlin))]
    assert draws[0] == draws[1] and draws[0][0] != draws[0][1]


def _sigma_run(kind, sig, ped, merlin, ref, seed=b"\x09" * 32):
    """Prove one sigma statement in one package: (proof, the commitments it
    speaks of as encodings, the public arguments of its verifier)."""
    L = ref.L
    r = np.random.default_rng(12)
    x, y, b1, b2, b3 = (int.from_bytes(r.bytes(40), "little") % L for _ in range(5))
    gens = ped.Gens(4, b"copy gens")
    rng = ped.BlindSource(seed)
    t = merlin.Transcript(b"sigma copy test")
    if kind == "KnowledgeProof":
        proof, C = sig.KnowledgeProof.prove(t, gens, x, b1, rng)
        points = [C]
    elif kind == "EqualityProof":
        proof, C1, C2 = sig.EqualityProof.prove(t, gens, x, b1, b2, rng)
        points = [C1, C2]
    elif kind == "ProductProof":
        proof, Cx, Cy, Cz = sig.ProductProof.prove(t, gens, x, b1, y, b2, b3, rng)
        points = [Cx, Cy, Cz]
    elif kind == "DualBaseEqualityProof":
        proof, C1, C2 = sig.DualBaseEqualityProof.prove(
            t, gens.G[0], gens.G[1], gens.H, x, b1, b2, rng)
        points = [C1, C2]
    else:
        xs, a = [x, y, b3], [3, 5, 7]
        dot = sum(p * q for p, q in zip(xs, a)) % L
        proof, Cx, Cy = sig.DotProductProof.prove(t, gens.sub(3), xs, b1, a, dot, b2, rng)
        points = [Cx, Cy]
    return proof, [p.ristretto_encode() for p in points], t.challenge_scalar(b"after")


def _sigma_verify(kind, proof_fields, encs, sig, ped, merlin):
    proof = getattr(sig, kind)(**proof_fields)
    gens = ped.Gens(4, b"copy gens")
    pts = [ped.decode(e) for e in encs]
    t = merlin.Transcript(b"sigma copy test")
    if kind == "DualBaseEqualityProof":
        return proof.verify(t, gens.G[0], gens.G[1], gens.H, *pts)
    if kind == "DotProductProof":
        return proof.verify(t, gens.sub(3), [3, 5, 7], *pts)
    return proof.verify(t, gens, *pts)


@pytest.mark.parametrize("kind", ["KnowledgeProof", "EqualityProof", "ProductProof",
                                  "DualBaseEqualityProof", "DotProductProof"])
def test_sigma_proofs_equal_and_cross_verify(kind):
    """One seed, one proof; each package's verifier accepts the other's
    proof and rejects it with one response changed."""
    pa, ea, ca = _sigma_run(kind, t_sigma, t_ped, t_merlin, t_ref)
    pb, eb, cb = _sigma_run(kind, j_sigma, j_ped, j_merlin, j_ref)
    fa, fb = ({f.name: getattr(p, f.name) for f in dataclasses.fields(p)} for p in (pa, pb))
    assert (fa, ea, ca) == (fb, eb, cb)
    assert _sigma_verify(kind, fb, eb, t_sigma, t_ped, t_merlin)
    assert _sigma_verify(kind, fa, ea, j_sigma, j_ped, j_merlin)
    key = "z" if "z" in fa else "z1"
    z = fa[key]
    bad = dict(fa, **{key: (z + 1) % t_ref.L if isinstance(z, int)
                      else type(z)([(z[0] + 1) % t_ref.L] + list(z[1:]))})
    assert not _sigma_verify(kind, bad, ea, t_sigma, t_ped, t_merlin)
    assert not _sigma_verify(kind, bad, ea, j_sigma, j_ped, j_merlin)


# ---- LP, SDP and zkinterface host modules ---------------------------------

import chip_smoke  # noqa: E402  (its instance writers; it imports nothing of either package)
from otti_tpu.codegen import lp_cert as j_lp_cert  # noqa: E402
from otti_tpu.codegen import sdp_cert as j_sdp_cert  # noqa: E402
from otti_tpu.io import mps as j_mps  # noqa: E402
from otti_tpu.io import sdpa as j_sdpa  # noqa: E402
from otti_tpu.io import zkif as j_zkif  # noqa: E402
from otti_tpu.oracle import lp_oracle as j_lp_oracle  # noqa: E402
from otti_tpu.oracle import sdp_infeas as j_sdp_infeas  # noqa: E402
from otti_tpu.oracle import sdp_oracle as j_sdp_oracle  # noqa: E402
from otti_tpu_torch.codegen import lp_cert as t_lp_cert  # noqa: E402
from otti_tpu_torch.codegen import sdp_cert as t_sdp_cert  # noqa: E402
from otti_tpu_torch.io import mps as t_mps  # noqa: E402
from otti_tpu_torch.io import sdpa as t_sdpa  # noqa: E402
from otti_tpu_torch.io import zkif as t_zkif  # noqa: E402
from otti_tpu_torch.oracle import lp_oracle as t_lp_oracle  # noqa: E402
from otti_tpu_torch.oracle import sdp_infeas as t_sdp_infeas  # noqa: E402
from otti_tpu_torch.oracle import sdp_oracle as t_sdp_oracle  # noqa: E402
from otti_tpu_torch.spartan import r1cs as t_r1cs  # noqa: E402

LP_SDP_COPIES = {
    "io/mps.py": t_mps, "oracle/lp_oracle.py": t_lp_oracle, "codegen/lp_cert.py": t_lp_cert,
    "io/sdpa.py": t_sdpa, "oracle/sdp_oracle.py": t_sdp_oracle,
    "oracle/sdp_infeas.py": t_sdp_infeas, "codegen/sdp_cert.py": t_sdp_cert,
    "io/zkif.py": t_zkif,
}

# three rows, three columns, no BOUNDS section
TINY_MPS = """NAME TINY3
ROWS
 N  COST
 L  R1
 L  R2
 G  R3
COLUMNS
    X1 COST -3.0 R1 1.0
    X1 R2 2.0
    X2 COST -2.0 R1 1.0
    X2 R3 1.0
    X3 COST -4.0 R1 1.0
    X3 R2 1.0 R3 1.0
RHS
    RHS R1 10.0 R2 8.0
    RHS R3 2.0
ENDATA
"""

# the RANGES text of tests/test_io_parsers.py::test_mps_ranges, with one bound
RANGES_MPS = """NAME RNGTEST
ROWS
 N  COST
 L  R1
 G  R2
 E  R3
 E  R4
COLUMNS
    X1 COST 1.0 R1 1.0
    X1 R2 1.0 R3 1.0
    X1 R4 1.0
RHS
    RHS R1 10.0 R2 2.0
    RHS R3 5.0 R4 7.0
RANGES
    RNG R1 4.0 R2 3.0
    RNG R3 2.0 R4 -3.0
BOUNDS
 UP BND X1 40.0
ENDATA
"""


@pytest.mark.parametrize("path", sorted(LP_SDP_COPIES))
def test_lp_sdp_zkif_module_is_a_marked_copy(path):
    """The copy is its original under one marking line; its imports are
    relative, so the same text reaches the port's own modules."""
    with open(os.path.join(REPO, "otti_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(REPO, "otti_tpu_torch", path)) as f:
        marker, copy = f.readline(), f.read()
    assert marker == f"# copied from otti_tpu/{path}\n"
    assert copy == original
    for value in vars(LP_SDP_COPIES[path]).values():
        owner = getattr(value, "__module__", None) or ""
        assert not owner.startswith("otti_tpu."), (path, value)


def _same_fields(a, b) -> bool:
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    return sorted(fa) == sorted(fb) and all(_same(np.asarray(fa[k]), np.asarray(fb[k]))
                                            if isinstance(fb[k], (np.ndarray, list))
                                            and k not in ("var_names", "row_names", "row_senses")
                                            else fa[k] == fb[k] for k in fb)


@pytest.mark.parametrize("text", [TINY_MPS, RANGES_MPS], ids=["tiny", "ranges"])
def test_parse_mps_equal(tmp_path, text):
    path = tmp_path / "p.mps"
    path.write_text(text)
    a, b = t_mps.parse_mps(str(path)), j_mps.parse_mps(str(path))
    assert _same_fields(a, b)
    assert t_mps.scipy_bounds(a) == j_mps.scipy_bounds(b)
    assert t_mps.sign_constraints(a) == j_mps.sign_constraints(b)
    if text is RANGES_MPS:
        rows = dict(zip(a.row_names, zip(a.row_senses, a.rhs)))
        assert rows["R1"] == ("L", 10.0) and rows["R1__rng"] == ("G", 6.0)
        assert rows["R4"] == ("G", 4.0) and rows["R4__rng"] == ("L", 7.0)
        assert t_mps.scipy_bounds(a) == [(0.0, 40.0)]


@pytest.fixture(scope="module")
def tiny_lp(tmp_path_factory):
    path = tmp_path_factory.mktemp("lp") / "tiny.mps"
    path.write_text(TINY_MPS)
    return t_mps.parse_mps(str(path)), j_mps.parse_mps(str(path))


def test_lp_oracle_and_certificate_equal(tiny_lp):
    pa, pb = tiny_lp
    (xa, ya, oa), (xb, yb, ob) = t_lp_oracle.solve(pa), j_lp_oracle.solve(pb)
    assert _same(xa, xb) and _same(ya, yb) and oa == ob == -36.0
    (sa, va, ia), (sb, vb, ib) = t_lp_cert.build(pa, xa, ya), j_lp_cert.build(pb, xb, yb)
    assert sa.digest() == sb.digest() and (va, ia) == (vb, ib)
    assert (sa.num_cons, sa.num_vars, sa.num_inputs) == (sb.num_cons, sb.num_vars, sb.num_inputs)
    assert isinstance(sa, t_r1cs.R1CSShape) and sa.is_satisfied(va, ia)
    # delta is a parameter of the statement: another circuit
    sd, vd, _ = t_lp_cert.build(pa, xa, ya, delta=0.5)
    sj, vj, _ = j_lp_cert.build(pb, xb, yb, delta=0.5)
    assert sd.digest() == sj.digest() != sa.digest() and vd == vj
    assert t_lp_cert.pick_frac_bits(pa) == j_lp_cert.pick_frac_bits(pb)


def test_generated_lp_is_solved_and_certified(tmp_path):
    """The seeded LP writer of chip_smoke.py: feasible, bounded, no gap."""
    path = str(tmp_path / "gen.mps")
    chip_smoke.write_lp_mps(path, 5, 6, seed=2)
    pa, pb = t_mps.parse_mps(path), j_mps.parse_mps(path)
    assert _same_fields(pa, pb) and pa.A.shape == (5, 6) and not pa.bounds
    assert (pa.A != 0).any(axis=0).all() and (pa.A != 0).any(axis=1).all()
    xa, ya, oa = t_lp_oracle.solve(pa)
    xb, yb, ob = j_lp_oracle.solve(pb)
    assert _same(xa, xb) and _same(ya, yb) and oa == ob < 0
    assert t_lp_cert.build(pa, xa, ya)[0].digest() == j_lp_cert.build(pb, xb, yb)[0].digest()


def test_lp_oracle_refuses_a_gap_from_an_active_bound(tmp_path):
    """The row-only certificate has no dual for an active upper bound."""
    path = tmp_path / "b.mps"
    path.write_text(TINY_MPS.replace("ENDATA", "BOUNDS\n UP BND X3 1.0\nENDATA"))
    for mps_mod, oracle in ((t_mps, t_lp_oracle), (j_mps, j_lp_oracle)):
        with pytest.raises(RuntimeError, match="duality gap"):
            oracle.solve(mps_mod.parse_mps(str(path)))


@pytest.fixture(scope="module")
def small_sdp(tmp_path_factory):
    """sdpa.random_problem(2, 2, seed=1), also through a .dat-s file."""
    (pa, Xa), (pb, Xb) = t_sdpa.random_problem(2, 2, seed=1), j_sdpa.random_problem(2, 2, seed=1)
    assert _same(Xa, Xb)
    path = str(tmp_path_factory.mktemp("sdp") / "r22.dat-s")
    chip_smoke.write_sdp_dats(path, pa)
    return pa, pb, path


def test_sdpa_problem_and_parser_equal(small_sdp):
    pa, pb, path = small_sdp
    qa, qb = t_sdpa.parse_dats(path), j_sdpa.parse_dats(path)
    for x, y in ((pa, pb), (qa, qb), (dataclasses.replace(qa, name="random"), pa)):
        assert (x.name, x.n, x.m) == (y.name, y.n, y.m)
        assert _same(x.C, y.C) and _same(x.b, y.b)
        assert all(_same(u, v) for u, v in zip(x.A, y.A))
    assert qa.name == "r22.dat-s"


def test_sdp_oracle_and_certificate_equal(small_sdp):
    pa, pb, _ = small_sdp
    (Xa, ya, Sa), (Xb, yb, Sb) = t_sdp_oracle.solve(pa), j_sdp_oracle.solve(pb)
    assert _same(Xa, Xb) and _same(ya, yb) and _same(Sa, Sb)
    La, Lb = t_sdp_oracle.cholesky_witness(Xa), j_sdp_oracle.cholesky_witness(Xb)
    Ma, Mb = t_sdp_oracle.cholesky_witness(Sa), j_sdp_oracle.cholesky_witness(Sb)
    assert _same(La, Lb) and _same(Ma, Mb)
    sa, va, ia = t_sdp_cert.build(pa, Xa, ya, La, Ma)
    sb, vb, ib = j_sdp_cert.build(pb, Xb, yb, Lb, Mb)
    assert sa.digest() == sb.digest() and (va, ia) == (vb, ib)
    assert sa.num_cons == sb.num_cons == 2110 and sa.is_satisfied(va, ia)
    se, ve, _ = t_sdp_cert.build(pa, Xa, ya, La, Ma, epsilon=0.5)
    sj, vj, _ = j_sdp_cert.build(pb, Xb, yb, Lb, Mb, epsilon=0.5)
    assert se.digest() == sj.digest() != sa.digest() and ve == vj


def test_sdp_infeasibility_arithmetic_equal(small_sdp):
    pa, pb, _ = small_sdp
    psd = [[2, 1], [1, 2]]
    indefinite = [[1, 2], [2, 1]]
    for mod in (t_sdp_infeas, j_sdp_infeas):
        assert mod.is_psd_exact(mod._frac_mat(np.asarray(psd, float)))
        assert not mod.is_psd_exact(mod._frac_mat(np.asarray(indefinite, float)))
    X = t_sdp_infeas._frac_mat(np.eye(2))
    assert t_sdp_infeas.check_certificate(pa, X) == j_sdp_infeas.check_certificate(pb, X)
    assert t_sdp_infeas._frob(X, X) == j_sdp_infeas._frob(X, X) == 2


def test_zkif_export_bytes_equal_and_import_round_trip(tmp_path, tiny_lp):
    pa, pb = tiny_lp
    xa, ya, _ = t_lp_oracle.solve(pa)
    sa, va, ia = t_lp_cert.build(pa, xa, ya)
    sb, vb, ib = j_lp_cert.build(pb, xa, ya)
    t_zkif.export_r1cs(sa, va, ia, str(tmp_path / "t"))
    j_zkif.export_r1cs(sb, vb, ib, str(tmp_path / "j"))
    for ext in (".zkif", ".inp.zkif", ".wit.zkif"):
        with open(tmp_path / ("t" + ext), "rb") as f, open(tmp_path / ("j" + ext), "rb") as g:
            data = f.read()
            assert data == g.read() and data
    for files in ((".zkif", ".wit.zkif", None), (".zkif", ".wit.zkif", ".inp.zkif")):
        circuit, wit, inp = (str(tmp_path / ("j" + e)) if e else None for e in files)
        s2, v2, i2 = t_zkif.import_r1cs(circuit, wit, inp)
        s3, v3, i3 = j_zkif.import_r1cs(circuit, wit, inp)
        assert isinstance(s2, t_r1cs.R1CSShape)
        assert s2.digest() == s3.digest() == sa.digest()
        assert (v2, i2) == (v3, i3) == (va, ia)
        assert s2.is_satisfied(v2, i2)


# ---- function-level copies (the CLI's prover choice, the strobe export) ----

FUNCTION_COPIES = [
    ("otti_tpu_torch/cli.py", "otti_tpu/cli.py", "_choose_fused"),
    ("otti_tpu_torch/transcript/device.py", "otti_tpu/transcript/device.py", "export_host_strobe"),
]


def _function_source(path, name):
    import ast

    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(text, node), text.splitlines()[node.lineno - 2]


@pytest.mark.parametrize("copy_path,orig_path,name", FUNCTION_COPIES, ids=lambda x: str(x))
def test_function_is_a_marked_copy(copy_path, orig_path, name):
    """The copied function is its original's text under one marking line."""
    copy, marker = _function_source(copy_path, name)
    original, _ = _function_source(orig_path, name)
    assert marker == f"# copied from {orig_path}::{name}"
    assert copy == original


@pytest.mark.parametrize("avail", [1, 2, 3, 8])
def test_mesh_size_is_a_marked_copy(avail, monkeypatch, capsys):
    """``cli._mesh_size`` is its original's text but for how it counts the
    devices (the port's ``_device_count``: the visible ones, or the ranks of
    a process group, not ``jax.devices()``), and resolves every request as
    the original does, with its stage messages, whatever the number of
    devices visible or of ranks in a group (on one visible device)."""
    import types

    import jax
    import torch.distributed as dist

    from otti_tpu import cli as j_cli
    from otti_tpu_torch import cli as t_cli

    copy, marker = _function_source("otti_tpu_torch/cli.py", "_mesh_size")
    original, _ = _function_source("otti_tpu/cli.py", "_mesh_size")
    assert marker == ("# copied from otti_tpu/cli.py::_mesh_size "
                      "(the devices counted by _device_count)")
    assert copy == (original
                    .replace("(mesh, shape) -> int:",
                             '(mesh, shape, device="cuda", group=None) -> int:')
                    .replace("    import jax\n\n    avail = len(jax.devices())",
                             "    avail = _device_count(device, group)"))
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * avail)
    group = object()
    monkeypatch.setattr(dist, "get_world_size", lambda g: avail if g is group else 1)
    capsys.readouterr()
    for visible, grp in (([None] * avail, None), ([None], group)):
        monkeypatch.setattr(t_cli, "_visible_devices", lambda device, v=visible: v)
        for cons, nvars in ((16, 8), (4, 2), (2, 64), (1024, 1024)):
            shape = types.SimpleNamespace(num_cons_padded=cons, num_vars_padded=nvars)
            for mesh in (None, "auto", "1", "2", "3", "4", "6", "8", "16"):
                got = t_cli._mesh_size(mesh, shape, "cpu", grp)
                said = capsys.readouterr().out
                assert got == j_cli._mesh_size(mesh, shape), (mesh, shape, grp)
                assert said == capsys.readouterr().out, (mesh, shape, grp)


@pytest.mark.parametrize("strobe", ["default", "python"])
def test_export_host_strobe_equal(strobe, monkeypatch):
    """The state and offsets handed to a device transcript, from the native
    strobe (its C layout) and from the Python one."""
    from otti_tpu.transcript import device as j_device
    from otti_tpu_torch.transcript import device as t_device

    if strobe == "python":
        monkeypatch.setattr(t_merlin, "_strobe_factory", lambda l: t_merlin.Strobe128(l))
        monkeypatch.setattr(j_merlin, "_strobe_factory", lambda l: j_merlin.Strobe128(l))
    ta, tb = t_merlin.Transcript(b"export"), j_merlin.Transcript(b"export")
    for t in (ta, tb):
        t.append_message(b"m", b"\x05" * 70)
        t.challenge_scalar(b"c")
        t.append_u64(b"n", 9)
    a, b = t_device.export_host_strobe(ta.strobe), j_device.export_host_strobe(tb.strobe)
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
