"""Zero-knowledge sumcheck (port of otti_tpu/spartan/zksumcheck.py).

Round polynomials are never revealed: the prover commits to each round
poly's coefficient vector, the claim chain lives in Pedersen commitments,
and each round carries one DotProductProof showing (with random weights
w0, w1 drawn after the round challenge) that

    w0 * (p_j(0) + p_j(1))  +  w1 * p_j(r_j)
      ==  <coeffs_j,  w0*u + w1*(1, r_j, r_j^2, ...)>,   u = (2, 1, ..., 1)

ties the committed coefficients to the committed claims e_j, e_{j+1}.
The device work is that of the plain sumcheck: every round is one call of
the fused round kernel (spartan/sumcheck_kernels.py), which binds the
previous challenge into the tables IN PLACE and evaluates the next round
polynomial, and one device->host fetch of its 3 (or 2) evaluations.  The
commitments and sigma proofs of a round run on the host.  Labels, blind
order and wire format are the JAX package's, so for one seed both packages
produce byte-identical proofs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..field.fields import SCALAR
from ..refimpl import numeric as ref
from ..transcript.merlin import Transcript

from ..field import ops as F
from .pedersen_host import BlindSource, Gens, commit, commit_vec, decode
from .sigma import DotProductProof
from .sumcheck_kernels import sumcheck_round
from .wire import OTTI

L = ref.L


# copied from otti_tpu/spartan/zksumcheck.py::_coeffs_from_evals
def _coeffs_from_evals(evals: list) -> list:
    """Monomial coefficients of the unique degree-(len-1) poly with
    p(i) = evals[i]."""
    d = len(evals) - 1
    # Lagrange -> monomial via solving the Vandermonde (tiny, exact)
    # p(x) = sum_i evals[i] * prod_{j!=i} (x - j)/(i - j)
    coeffs = [0] * (d + 1)
    for i in range(d + 1):
        # numerator poly prod_{j != i} (x - j)
        num = [1]
        for j in range(d + 1):
            if j == i:
                continue
            num = [
                ((num[k] if k < len(num) else 0) * (-j) + (num[k - 1] if k >= 1 else 0))
                % L
                for k in range(len(num) + 1)
            ]
        den = 1
        for j in range(d + 1):
            if j != i:
                den = den * (i - j) % L
        scale = evals[i] * pow(den, L - 2, L) % L
        for k in range(len(num)):
            coeffs[k] = (coeffs[k] + scale * num[k]) % L
    return coeffs


# copied from otti_tpu/spartan/zksumcheck.py::_poly_eval
def _poly_eval(coeffs: list, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % L
    return acc


def _weights(w0: int, w1: int, r: int, degree: int) -> list:
    """w0 * (2, 1, .., 1) + w1 * (1, r, r^2, ...)."""
    return [(w0 * (2 if k == 0 else 1) + w1 * pow(r, k, L)) % L for k in range(degree + 1)]


@dataclasses.dataclass
class ZKSumcheckProof:
    comm_polys: list  # bytes32 per round
    comm_evals: list  # bytes32 per round (C_{e_{j+1}})
    dot_proofs: list  # DotProductProof per round


def prove_zk(
    degree: int,
    claim: int,
    claim_blind: int,
    tables: tuple,
    transcript: Transcript,
    label: bytes,
    gens: Gens,
    rng: BlindSource,
    wire=None,
):
    """tables: (eq, pa, pb, pc) for degree 3 or (pm, pz) for degree 2, each
    ``[n, 22]`` on one device; they are updated in place.

    Returns (proof, rs, final_table_values, e_final, blind_final).
    """
    wire = wire or OTTI
    tables = list(tables)
    n = tables[0].shape[0]
    gens_d = gens.sub(degree + 1)
    gens_1 = gens.sub(1)

    e, be = claim % L, claim_blind % L
    comm_polys, comm_evals, dots, rs = [], [], [], []
    active = n
    evals_dev = sumcheck_round(tables, degree) if n > 1 else None
    while active > 1:
        ev = F.to_ints(SCALAR, evals_dev)  # the round's one device->host fetch
        evals = [ev[0], (e - ev[0]) % L] + ev[1:]
        coeffs = _coeffs_from_evals(evals)
        b_poly = rng.scalar()
        C_poly = commit_vec(coeffs, b_poly, gens_d)
        transcript.append_point(wire.rl(label, wire.sc_comm_poly), C_poly.ristretto_encode())
        comm_polys.append(C_poly.ristretto_encode())
        r = transcript.challenge_scalar(wire.rl(label, wire.sc_challenge))
        rs.append(r)

        e_next = _poly_eval(coeffs, r)
        b_next = rng.scalar()
        C_next = commit(e_next, b_next, gens_1)
        transcript.append_point(wire.rl(label, wire.sc_comm_eval), C_next.ristretto_encode())
        comm_evals.append(C_next.ristretto_encode())

        w0, w1 = wire.draw_weights(transcript, label)
        a = _weights(w0, w1, r, degree)
        y = (w0 * e + w1 * e_next) % L
        ry = (w0 * be + w1 * b_next) % L
        dp, _, _ = DotProductProof.prove(transcript, gens_d, coeffs, b_poly, a, y, ry, rng)
        dots.append(dp)

        # bind r and evaluate the next round (the bare bind when one pair is
        # left): launched before the host waits on anything of the device
        evals_dev = sumcheck_round(tables, degree, r, active // 2)
        e, be = e_next, b_next
        active //= 2

    finals = tuple(F.to_ints(SCALAR, torch.stack([t[0] for t in tables])))
    return ZKSumcheckProof(comm_polys, comm_evals, dots), rs, finals, e, be


def verify_zk(
    degree: int,
    proof: ZKSumcheckProof,
    C_claim: ref.EdPoint,
    n_rounds: int,
    transcript: Transcript,
    label: bytes,
    gens: Gens,
    wire=None,
):
    """Returns (rs, C_final) or raises ValueError.  Host only."""
    wire = wire or OTTI
    if len(proof.comm_polys) != n_rounds or len(proof.dot_proofs) != n_rounds:
        raise ValueError("zk-sumcheck: wrong round count")
    gens_d = gens.sub(degree + 1)
    C_e = C_claim
    rs = []
    for j in range(n_rounds):
        C_poly = decode(proof.comm_polys[j])
        transcript.append_point(wire.rl(label, wire.sc_comm_poly), proof.comm_polys[j])
        r = transcript.challenge_scalar(wire.rl(label, wire.sc_challenge))
        rs.append(r)
        C_next = decode(proof.comm_evals[j])
        transcript.append_point(wire.rl(label, wire.sc_comm_eval), proof.comm_evals[j])
        w0, w1 = wire.draw_weights(transcript, label)
        a = _weights(w0, w1, r, degree)
        C_y = C_e * w0 + C_next * w1
        if not proof.dot_proofs[j].verify(transcript, gens_d, a, C_poly, C_y):
            raise ValueError(f"zk-sumcheck: round {j} dot-product proof failed")
        C_e = C_next
    return rs, C_e
