"""Sumcheck prover/verifier, Spartan phases 1 and 2 (port of
otti_tpu/spartan/sumcheck.py: lagrange_eval, prove_cubic, prove_quad,
verify_rounds).

Each round is one call of the fused round kernel (spartan/sumcheck_kernels.py)
that binds the previous challenge into the tables IN PLACE and evaluates
the next round polynomial, plus one device->host fetch of its 3 (or 2)
evaluations for the host Merlin transcript.  The wire format and the
transcript schedule are the JAX package's, so proofs are byte-identical.
"""

from __future__ import annotations

from ..field.fields import SCALAR
from ..transcript.merlin import Transcript

from ..field import ops as F
from .sumcheck_kernels import sumcheck_round

MOD = SCALAR.modulus


def _scalar_bytes(x: int) -> bytes:
    return (x % MOD).to_bytes(32, "little")


def lagrange_eval(evals: list, r: int) -> int:
    """Evaluate the degree-(len-1) poly with values ``evals`` at 0..d, at r."""
    d = len(evals) - 1
    total = 0
    for t in range(d + 1):
        num, den = 1, 1
        for s in range(d + 1):
            if s == t:
                continue
            num = num * ((r - s) % MOD) % MOD
            den = den * ((t - s) % MOD) % MOD
        total = (total + evals[t] * num % MOD * pow(den, MOD - 2, MOD)) % MOD
    return total


def _prove(claim: int, tables: list, degree: int, transcript: Transcript, label: bytes):
    n = tables[0].shape[0]
    e = claim % MOD
    rounds, rs = [], []
    evals_dev = sumcheck_round(tables, degree) if n > 1 else None
    active = n
    while active > 1:
        ev = F.to_ints(SCALAR, evals_dev)  # the round's one device->host fetch
        e0, e1 = ev[0], (e - ev[0]) % MOD
        evals = [e0, e1] + ev[1:]
        transcript.append_scalar(label + b"/e0", _scalar_bytes(e0))
        for j, v in enumerate(ev[1:]):
            transcript.append_scalar(label + b"/e%d" % (j + 2), _scalar_bytes(v))
        r = transcript.challenge_scalar(label + b"/r")
        rs.append(r)
        rounds.append(evals)
        e = lagrange_eval(evals, r)
        evals_dev = sumcheck_round(tables, degree, r, active // 2)
        active //= 2
    finals = tuple(F.to_int(SCALAR, t[0]) for t in tables)
    return rounds, rs, finals, e


def prove_cubic(claim: int, eq, pa, pb, pc, transcript: Transcript, label: bytes):
    """Phase-1 sumcheck of sum eq (A B - C).  The four tables are updated in
    place.  Returns (round_evals [e0,e1,e2,e3] per round, r_points,
    final (eq, Az, Bz, Cz) values, final claim)."""
    return _prove(claim, [eq, pa, pb, pc], 3, transcript, label)


def prove_quad(claim: int, pm, pz, transcript: Transcript, label: bytes):
    """Phase-2 sumcheck of sum M Z (tables updated in place).  Returns
    (round_evals [e0,e1,e2], r_points, final (M, Z) values, final claim)."""
    return _prove(claim, [pm, pz], 2, transcript, label)


def verify_rounds(claim: int, round_polys: list, degree: int, transcript: Transcript,
                  label: bytes):
    """Replay the Fiat-Shamir schedule; returns (final_claim, r_points) or
    raises ValueError."""
    e = claim % MOD
    rs = []
    for evals in round_polys:
        if len(evals) != degree + 1:
            raise ValueError("sumcheck: wrong round poly size")
        e0 = evals[0]
        if evals[1] != (e - e0) % MOD:
            raise ValueError("sumcheck: p(0)+p(1) != claim")
        transcript.append_scalar(label + b"/e0", _scalar_bytes(e0))
        for j, v in enumerate(evals[2:]):
            transcript.append_scalar(label + b"/e%d" % (j + 2), _scalar_bytes(v))
        r = transcript.challenge_scalar(label + b"/r")
        rs.append(r)
        e = lagrange_eval(evals, r)
    return e, rs
