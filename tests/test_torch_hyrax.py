"""The stages under the port's SNARK mode against the JAX package.

Inputs are made from numpy seeds: the field inversion against Fermat's
power, MLE evaluation, Hyrax commitments of cubes of 1 to 64 entries
(against the host Pedersen commitment), the combined openings, and the
custom-combination sumcheck at degree 3 and 4 against
otti_tpu.spartan.sumcheck.prove_custom on the same tables and transcript.
The port runs on the CPU here (plain versions of its kernels).  Tolerance:
exact equality, this is modular arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.field.fields import BASE, SCALAR, ints_to_limbs
from otti_tpu.spartan import hyrax as JH
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import spark as JSP
from otti_tpu.spartan import sumcheck as JSC
from otti_tpu.transcript.merlin import Transcript as JTranscript
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.spartan import hyrax as TH
from otti_tpu_torch.spartan import mle as TM
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import pedersen_host as TP
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import spark as TSP
from otti_tpu_torch.spartan import sumcheck as TSC
from otti_tpu_torch.transcript.merlin import Transcript as TTranscript

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus


def _ints(n, seed, mod=M):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % mod for _ in range(n)]


# ---- the repairs: field inversion, MLE evaluation --------------------------

@pytest.mark.parametrize("spec", [SCALAR, BASE], ids=["scalar", "base"])
@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_field_inv_matches_fermat_with_zeros(spec, n):
    m = spec.modulus
    xs = _ints(n, 100 + n, m)
    xs[0] = 0
    if n > 2:
        xs[n // 2], xs[-1] = 0, m - 1
    got = F.inv(spec, F.from_ints(spec, xs))
    assert F.to_ints(spec, got) == [pow(x, m - 2, m) for x in xs]
    assert got.shape == (n, 22)
    # a batch of any shape, and the semi form of a multiple of m is a zero too
    grid = F.inv(spec, F.from_ints(spec, xs).reshape(1, n, 22))
    assert grid.shape == (1, n, 22) and F.to_ints(spec, grid) == F.to_ints(spec, got)


def test_field_inv_of_semi_zero_and_curve_batch_inv():
    from otti_tpu_torch.curve import edwards as E

    semi_zero = F.add(SCALAR, F.from_ints(SCALAR, [M - 1]), F.from_ints(SCALAR, [1]))
    assert F.to_ints(SCALAR, F.inv(SCALAR, semi_zero)) == [0]
    xs = _ints(7, 3, BASE.modulus)
    want = [pow(x, BASE.modulus - 2, BASE.modulus) for x in xs]
    assert F.to_ints(BASE, E.batch_inv(F.from_ints(BASE, xs))) == want


@pytest.mark.parametrize("mu", [0, 1, 4])
def test_mle_evaluate_matches_jax_and_host(mu):
    vals, point = _ints(1 << mu, 7 + mu), _ints(mu, 8 + mu)
    got = F.to_int(SCALAR, TM.evaluate(F.from_ints(SCALAR, vals), F.from_ints(SCALAR, point)))
    assert got == TN._mle_eval_host(vals, point)
    assert got == TH.eval_poly_host(F.from_ints(SCALAR, vals), point)
    if mu:
        assert got == JH.eval_poly_host(jnp.asarray(ints_to_limbs(vals)), point)


# ---- Hyrax commitments and openings of whole cubes -------------------------

@pytest.mark.parametrize("n", [1, 2, 16, 64])
def test_commit_poly_encodings(n):
    """Cubes of 1 and 2 entries give a 1 x 1 and a 1 x 2 grid.  Every size
    against the Pedersen commitment of each row on the host (a marked copy,
    held against its original in tests/test_torch_host_copies.py); the JAX
    package's own encodings are compared in tests/test_torch_snark.py, on
    the three cubes of the toy SNARK's commitment."""
    assert TH.hyrax_dims(n) == JH.hyrax_dims(n)
    mu_rows, mu_cols = TH.hyrax_dims(n)
    rows, cols = 1 << mu_rows, 1 << mu_cols
    vals = _ints(n, 30 + n)
    vals[0] = 0
    got = TH.commit_poly(F.from_ints(SCALAR, vals), TSP.GENS)
    gens = TP.Gens(cols, TSP.GENS)
    assert got == [TP.commit_vec(vals[r * cols:(r + 1) * cols], 0, gens).ristretto_encode()
                   for r in range(rows)]


@pytest.mark.parametrize("n", [2, 16])
def test_rlc_openings_match_jax_and_verify(n):
    mu = n.bit_length() - 1
    polys = [_ints(n, 40 + k) for k in range(3)]
    weights, point = _ints(3, 50), _ints(mu, 51)
    j_polys = [jnp.asarray(ints_to_limbs(p)).reshape(n, -1) for p in polys]
    t_polys = [F.from_ints(SCALAR, p) for p in polys]
    u = TH.open_rlc(t_polys, weights, point)
    assert u == JH.open_rlc(j_polys, weights, point)
    comms = [TH.commit_poly(p, TSP.GENS) for p in t_polys]
    claims = [TN._mle_eval_host(p, point) for p in polys]
    assert TH.verify_rlc(comms, weights, point, claims, u, TSP.GENS)
    assert JH.verify_rlc(comms, weights, point, claims, u, JSP.GENS)
    assert not TH.verify_rlc(comms, weights, point, [claims[0] + 1] + claims[1:], u, TSP.GENS)
    tj, tt = JTranscript(b"rlc test"), TTranscript(b"rlc test")
    pj = JH.open_rlc_bullet(j_polys, weights, point, tj, JSP.GENS)
    pt = TH.open_rlc_bullet(t_polys, weights, point, tt, TSP.GENS)
    assert JS.dumps(pj) == TS.dumps(pt)
    assert tj.challenge_scalar(b"after") == tt.challenge_scalar(b"after")
    assert TH.verify_rlc_bullet(comms, weights, point, claims, pt, TSP.GENS,
                                TTranscript(b"rlc test"))
    assert JH.verify_rlc_bullet(comms, weights, point, claims, JS.loads(TS.dumps(pt)),
                                JSP.GENS, JTranscript(b"rlc test"))
    assert not TH.verify_rlc_bullet(comms, weights, point, claims[:2] + [claims[2] + 1], pt,
                                    TSP.GENS, TTranscript(b"rlc test"))


# ---- the custom-combination sumcheck ---------------------------------------

@pytest.mark.parametrize("key,degree,k_tables,k_consts,n", [
    ("spark_table", 3, 4, 2, 8),
    ("spark_entry4", 4, 9, 4, 16),
])
def test_prove_custom_matches_jax(key, degree, k_tables, k_consts, n):
    """Fixed tables and a fixed transcript: the same rounds, challenges, final
    values and final claim, and the replay accepts them.  The tables handed
    in are left untouched."""
    assert TSC._eval_points(degree) == JSC._eval_points(degree)
    vals = [_ints(n, 60 + degree * 10 + i) for i in range(k_tables)]
    consts = _ints(k_consts, 70 + degree)
    t_tables = tuple(F.from_ints(SCALAR, v) for v in vals)
    t_consts = tuple(F.from_int(SCALAR, c) for c in consts)
    comb = TSC._COMB_REGISTRY[key]
    claim = F.to_int(SCALAR, F.sum_reduce(SCALAR, comb(t_consts, t_tables), axis=0))
    before = [t.clone() for t in t_tables]
    tj, tt = JTranscript(b"custom test"), TTranscript(b"custom test")
    want = JSC.prove_custom(
        claim, tuple(jnp.asarray(ints_to_limbs(v)) for v in vals),
        tuple(jnp.asarray(ints_to_limbs([c])[0]) for c in consts), key, degree, tj, b"cs")
    got = TSC.prove_custom(claim, t_tables, t_consts, key, degree, tt, b"cs")
    assert got == want
    rounds, rs, finals, e = got
    assert len(rounds) == n.bit_length() - 1 and all(len(r) == degree + 1 for r in rounds)
    assert all((a == b).all() for a, b in zip(before, t_tables))
    assert tj.challenge_scalar(b"after") == tt.challenge_scalar(b"after")
    for verify, transcript in ((TSC.verify_custom, TTranscript), (JSC.verify_custom, JTranscript)):
        assert verify(claim, rounds, degree, transcript(b"custom test"), b"cs") == (e, rs)
    # the final claim is the combination of the final table values
    final_limbs = tuple(F.from_ints(SCALAR, [v]) for v in finals)
    assert F.to_int(SCALAR, comb(t_consts, final_limbs)[0]) == e
    bad = [list(r) for r in rounds]
    bad[1][0] = (bad[1][0] + 1) % M
    with pytest.raises(ValueError):
        TSC.verify_custom(claim, bad, degree, TTranscript(b"custom test"), b"cs")
    with pytest.raises(ValueError):
        TSC.verify_custom(claim, rounds, degree + 1, TTranscript(b"custom test"), b"cs")
