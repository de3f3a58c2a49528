"""Sumcheck prover/verifier, Spartan phases 1 and 2 and the SPARK layer's
custom combinations (port of otti_tpu/spartan/sumcheck.py: lagrange_eval,
prove_cubic, prove_quad, verify_rounds, register_comb, prove_custom,
verify_custom).

A round of phase 1 or 2 is one call of the fused round kernel
(spartan/sumcheck_kernels.py) that binds the previous challenge into the
tables IN PLACE and evaluates the next round polynomial, plus one
device->host fetch of its 3 (or 2) evaluations for the host Merlin
transcript.  A round with a registered combination is torch ops around the
field multiply kernel, over all tables and all evaluation points at once,
with the same one fetch.  The wire format and the transcript schedule are
the JAX package's, so proofs are byte-identical.
"""

from __future__ import annotations

import torch

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


# ---------------------------------------------------------------------------
# Custom-combination sumcheck (the SPARK layer): the round combination is
# looked up in a registry by key, as in the JAX package.
# ---------------------------------------------------------------------------

_COMB_REGISTRY: dict = {}


def register_comb(key: str, fn) -> None:
    """fn(consts: tuple of [22] limb vectors, exts: tuple of [..., 22]
    tensors, one per table) -> [..., 22] combined values per point (of
    degree <= the sumcheck's ``degree`` in each variable)."""
    _COMB_REGISTRY[key] = fn


def _eval_points(degree: int) -> tuple:
    return (0,) + tuple(range(2, degree + 1))


def _custom_evals(stacked: torch.Tensor, half: int, consts: tuple, comb, degree: int):
    """The round polynomial of sum comb(tables) over the pairs (t[i],
    t[i + half]), i < half, at the points 0, 2, ..., degree -> canonical
    [degree, 22].  ``stacked`` is [k, n, 22]; the extensions at every point
    go through ``comb`` in one call ([points, half, 22] per table)."""
    lo, cur = stacked[:, :half], stacked[:, half : 2 * half]  # the tables at X = 0, 1
    d = F.sub(SCALAR, cur, lo)
    exts = [lo]
    for _ in range(2, degree + 1):
        cur = F.add(SCALAR, cur, d)
        exts.append(cur)
    per_table = torch.stack(exts, dim=1)  # [k, points, half, 22]
    vals = comb(consts, tuple(per_table.unbind(0)))
    return F.canon(SCALAR, F.sum_reduce(SCALAR, vals, axis=1))


def prove_custom(claim: int, tables: tuple, consts: tuple, key: str, degree: int,
                 transcript: Transcript, label: bytes):
    """Host-driven sumcheck of sum_x comb(consts, tables(x)) with a
    registered round combination.  The tables ([n, 22] each) are left as
    they are: the rounds bind a stacked copy in place, which never grows.
    Wire format as the standard rounds (values at 0..degree, p(1) implied);
    returns (rounds, r_points, final table values, final claim)."""
    comb = _COMB_REGISTRY[key]
    stacked = torch.stack(list(tables))  # [k, n, 22], the rounds' working copy
    n = stacked.shape[1]
    e = claim % MOD
    rounds, rs = [], []
    active = n
    while active > 1:
        half = active // 2
        # the round's one device->host fetch
        ev = F.to_ints(SCALAR, _custom_evals(stacked, half, consts, comb, degree))
        e0 = ev[0]
        evals = [e0, (e - e0) % MOD] + ev[1:]
        transcript.append_scalar(label + b"/e0", _scalar_bytes(e0))
        for j, v in enumerate(ev[1:]):
            transcript.append_scalar(label + b"/e%d" % (j + 2), _scalar_bytes(v))
        r = transcript.challenge_scalar(label + b"/r")
        rounds.append(evals)
        rs.append(r)
        e = lagrange_eval(evals, r)
        lo, hi = stacked[:, :half], stacked[:, half:active]
        r_limbs = F.from_int(SCALAR, r, stacked.device)
        stacked[:, :half] = F.add(SCALAR, lo, F.mul(SCALAR, F.sub(SCALAR, hi, lo), r_limbs))
        active = half
    finals = tuple(F.to_ints(SCALAR, stacked[:, 0]))
    return rounds, rs, finals, e


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


def verify_custom(claim: int, round_polys: list, degree: int, transcript: Transcript,
                  label: bytes):
    """Replay of a custom-combination sumcheck: the schedule of the standard
    rounds.  Returns (final_claim, r_points) or raises ValueError."""
    return verify_rounds(claim, round_polys, degree, transcript, label)
