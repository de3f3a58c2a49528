"""Port curve, comb MSM, commitments and sparse products against the JAX
package (otti_tpu.curve.edwards via refimpl, otti_tpu.msm.pippenger,
otti_tpu.spartan.commitments, otti_tpu.spartan.r1cs).

Points are compared as host reference points (projective equality) or as
32-byte ristretto encodings; field values as canonical integers; the comb
table bit for bit.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.field.fields import SCALAR, ints_to_limbs, limbs_to_int
from otti_tpu.field import ops as JF
from otti_tpu.msm import pippenger as JP
from otti_tpu.refimpl import numeric as ref
from otti_tpu.spartan import commitments as JC
from otti_tpu.spartan import r1cs as JR
from otti_tpu_torch import convert
from otti_tpu_torch.curve import edwards as E
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.msm import pippenger as TP
from otti_tpu_torch.spartan import commitments as TC
from otti_tpu_torch.spartan import r1cs as TR

M = SCALAR.modulus
LABEL = b"port-test gens"


def _points(n):
    return list(TC.gen_points_host(n, LABEL)[0])


def test_gen_points_host_is_the_jax_derivation():
    ours, h = TC.gen_points_host(4, LABEL)
    theirs, h2 = JC.gen_points_host(4, LABEL)
    assert all(a == b for a, b in zip(ours, theirs)) and h == h2


def test_add_double_match_refimpl():
    pts = _points(6)
    p = E.stack([E.from_ref(q) for q in pts])
    q = E.stack([E.from_ref(q) for q in pts[1:] + pts[:1]])
    got_add = E.to_refs(E.add(p, q))
    got_dbl = E.to_refs(E.double(p))
    for i, a in enumerate(pts):
        b = pts[(i + 1) % len(pts)]
        assert got_add[i] == a + b
        assert got_dbl[i] == a.double()
    ident = E.to_refs(E.add(p, E.identity((len(pts),))))
    assert all(x == y for x, y in zip(ident, pts))


def test_sum_points_and_affine_pack_roundtrip():
    pts = _points(5)
    batch = E.stack([E.from_ref(q) for q in pts])
    total = pts[0]
    for q in pts[1:]:
        total = total + q
    assert E.to_ref(E.sum_points(batch)) == total
    packed = E.to_affine_pack(E.double(batch))
    back = E.to_refs(E.from_affine_pack(packed))
    assert all(b == q.double() for b, q in zip(back, pts))


N_GENS = 2  # the fewest that cover more than one generator; all 32 windows each


@pytest.fixture(scope="module")
def jax_comb_table():
    """The JAX package's comb table for N_GENS generators, built once."""
    return JP.fixed_base_tables(N_GENS, LABEL)


def test_comb_table_matches_jax(jax_comb_table):
    """The port's doubling-built table against the JAX table (carried
    across with convert.comb_table), entry for entry."""
    jtbl, n_win, n_d = jax_comb_table
    assert (n_win, n_d) == (TP.N_WIN, TP.N_DIGITS)
    ours = TP.build_comb_table(_points(N_GENS), "cpu")
    assert ours.shape == (N_GENS * n_win * n_d, 16)
    assert torch.equal(ours, convert.comb_table(jtbl["p"])["p"])


def test_commit_rows_and_encodings_match_jax(jax_comb_table):
    rng = np.random.default_rng(5)
    rows, cols = 4, N_GENS
    vals = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(rows * cols)]
    vals[:3] = [0, 1, M - 1]
    W = ints_to_limbs(vals).reshape(rows, cols, -1)
    want = JC.encode_points(JC.commit_rows(jnp.asarray(W), [0] * rows, LABEL))
    jtbl, _, _ = jax_comb_table
    got = TC.encode_points(TC.commit_rows(convert.limbs(W), LABEL, tbl=convert.comb_table(jtbl["p"])))
    assert got == want
    # and through the port's own (cached) table
    assert TC.encode_points(TC.commit_rows(convert.limbs(W), LABEL)) == want


def _instance():
    import __graft_entry__ as g

    shape, zvars = g._toy_r1cs(n_cons=16, n_vars=8, seed=3)
    return shape, zvars


def test_sparse_products_match_jax():
    shape_j, zvars = _instance()
    jdev = shape_j.to_device()
    tdev = convert.r1cs_device(jdev.num_cons, jdev.num_z, jdev.num_vars, jdev.num_inputs,
                               [tuple(np.asarray(a) for a in m) for m in jdev.mats],
                               jdev.digest)
    z_np = np.asarray(JR.assemble_z(jnp.asarray(ints_to_limbs(zvars)), None, jdev.num_vars))
    z = TR.assemble_z(F.from_ints(SCALAR, zvars), None, tdev.num_vars)
    assert F.to_ints(SCALAR, z) == [limbs_to_int(r) % M for r in z_np]

    def ints(x):
        return [limbs_to_int(r) % M for r in np.asarray(JF.canon_jit(SCALAR)(x)).reshape(-1, 22)]

    for a, b in zip(jdev.matvecs(jnp.asarray(z_np)), tdev.matvecs(z)):
        assert F.to_ints(SCALAR, b) == ints(a)
    rng = np.random.default_rng(6)
    e_rx = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(jdev.num_cons)]
    e_ry = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(jdev.num_z)]
    w = [7, 11, 13]
    je = jnp.asarray(ints_to_limbs(e_rx))
    want = jdev.matvec_T_weighted(tuple(jnp.asarray(ints_to_limbs([x]))[0] for x in w), je)
    got = tdev.matvec_T_weighted(tuple(F.from_ints(SCALAR, [x])[0] for x in w),
                                 F.from_ints(SCALAR, e_rx))
    assert F.to_ints(SCALAR, got) == ints(want)
    want3 = jdev.eval_at(je, jnp.asarray(ints_to_limbs(e_ry)))
    got3 = tdev.eval_at(F.from_ints(SCALAR, e_rx), F.from_ints(SCALAR, e_ry))
    assert [F.to_int(SCALAR, x) for x in got3] == [ints(x)[0] for x in want3]
    # the port's own to_device gives the same products (no zero-padding)
    tdev2 = TR.R1CSShape(shape_j.num_cons, shape_j.num_vars, shape_j.num_inputs,
                         shape_j.A, shape_j.B, shape_j.C).to_device("cpu")
    assert tdev2.digest == jdev.digest
    for a, b in zip(tdev.matvecs(z), tdev2.matvecs(z)):
        assert F.to_ints(SCALAR, a) == F.to_ints(SCALAR, b)


def test_eq_table_matches_jax():
    from otti_tpu.spartan import mle as JM
    from otti_tpu_torch.spartan import mle as TM

    rs = [3, M - 2, 12345678901234567890, 0, 1]
    want = np.asarray(JF.canon_jit(SCALAR)(JM.eq_table(jnp.asarray(ints_to_limbs(rs)))))
    got = TM.eq_table(F.from_ints(SCALAR, rs))
    assert F.to_ints(SCALAR, got) == [limbs_to_int(r) % M for r in want]


def test_scalars_to_bits_and_digits():
    vals = [0, 1, M - 1, 0xDEADBEEF << 200]
    bits = E.scalars_to_bits(F.from_ints(SCALAR, vals), 256)
    for v, row in zip(vals, bits.tolist()):
        assert sum(b << i for i, b in enumerate(row)) == v
    digits = TP.window_digits(F.from_ints(SCALAR, vals))
    for v, row in zip(vals, digits.tolist()):
        assert sum(d << (8 * i) for i, d in enumerate(row)) == v


@pytest.mark.cuda
def test_commit_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    W = ints_to_limbs([int.from_bytes(rng.bytes(40), "little") % M for _ in range(32)])
    W = W.reshape(4, 8, -1)
    cpu = TC.encode_points(TC.commit_rows(convert.limbs(W), LABEL))
    assert TC.encode_points(TC.commit_rows(convert.limbs(W, "cuda"), LABEL)) == cpu
