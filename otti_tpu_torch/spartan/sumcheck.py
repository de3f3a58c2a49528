"""Sumcheck prover/verifier, Spartan phases 1 and 2 and the SPARK layer's
custom combinations (port of otti_tpu/spartan/sumcheck.py: lagrange_eval,
prove_cubic, prove_quad, verify_rounds, register_comb, prove_custom,
prove_custom_device, verify_custom).

A round of phase 1 or 2 is one call of the fused round kernel
(spartan/sumcheck_kernels.py) that binds the previous challenge into the
tables IN PLACE and evaluates the next round polynomial, plus one
device->host fetch of its 3 (or 2) evaluations for the host Merlin
transcript.  A round with a registered combination is one call of the
custom round kernel (spartan/custom_kernels.py, K5) on a stacked working
copy of the tables: ``prove_custom`` fetches each round's evaluations for
the host transcript, ``prove_custom_device`` (SPARK's form, as in the JAX
package) runs every round with its transcript step as one call of the
kernel's fused entry on the device and fetches once.
The wire format and the transcript schedule are the JAX package's, so
proofs are byte-identical.
"""

from __future__ import annotations

import torch

from ..field.fields import N_LIMBS, SCALAR, limbs_to_int
from ..transcript.merlin import Transcript

from ..field import ops as F
from .custom_kernels import (_COMB_REGISTRY, _eval_points, custom_round,  # noqa: F401
                             custom_round_fs, register_comb, round_program)
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


def _absorb_round(e: int, ev: list, transcript: Transcript, label: bytes):
    """One round on the host transcript: the values at 0, 2, ..., degree
    absorbed (p(1) = e - p(0) is implied), the challenge drawn.  Returns
    (the round's values at 0..degree, r, the next claim)."""
    e0 = ev[0]
    evals = [e0, (e - e0) % MOD] + ev[1:]
    transcript.append_scalar(label + b"/e0", _scalar_bytes(e0))
    for j, v in enumerate(ev[1:]):
        transcript.append_scalar(label + b"/e%d" % (j + 2), _scalar_bytes(v))
    r = transcript.challenge_scalar(label + b"/r")
    return evals, r, lagrange_eval(evals, r)


def _host_rounds(claim: int, n: int, round_fn, transcript: Transcript, label: bytes):
    """The rounds of a sumcheck over n rows with the host transcript:
    ``round_fn(r, prev_half)`` binds r into the tables (r None: the first
    round, no bind) and returns the next round's evaluations on the device
    (None after the bare final bind), fetched once a round.  Returns
    (rounds, r_points, final claim)."""
    e = claim % MOD
    rounds, rs = [], []
    evals_dev = round_fn(None, None) if n > 1 else None
    active = n
    while active > 1:
        ev = F.to_ints(SCALAR, evals_dev)  # the round's one device->host fetch
        evals, r, e = _absorb_round(e, ev, transcript, label)
        rounds.append(evals)
        rs.append(r)
        evals_dev = round_fn(r, active // 2)
        active //= 2
    return rounds, rs, e


def _prove(claim: int, tables: list, degree: int, transcript: Transcript, label: bytes):
    rounds, rs, e = _host_rounds(claim, tables[0].shape[0],
                                 lambda r, ah: sumcheck_round(tables, degree, r, ah),
                                 transcript, label)
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
# looked up in a registry by key (custom_kernels.register_comb), as in the
# JAX package.
# ---------------------------------------------------------------------------

def _working_copy(tables: tuple, consts: tuple):
    """(the [k, n, 22] stacked copy that the rounds bind in place, the
    [kc, 22] constants); the caller's tables are left as they are."""
    return torch.stack(list(tables)), torch.stack(list(consts))


def prove_custom(claim: int, tables: tuple, consts: tuple, key: str, degree: int,
                 transcript: Transcript, label: bytes):
    """Host-driven sumcheck of sum_x comb(consts, tables(x)) with a
    registered round combination: a ``custom_round`` a round and one fetch
    of its evaluations for the host transcript.  The tables ([n, 22] each)
    are left as they are.  Wire format as the standard rounds (values at
    0..degree, p(1) implied); returns (rounds, r_points, final table
    values, final claim)."""
    stacked, cst = _working_copy(tables, consts)
    rounds, rs, e = _host_rounds(claim, stacked.shape[1],
                                 lambda r, ah: custom_round(stacked, cst, key, degree, r, ah),
                                 transcript, label)
    finals = tuple(F.to_ints(SCALAR, stacked[:, 0]))
    return rounds, rs, finals, e


def prove_custom_device(claim: int, tables: tuple, consts: tuple, key: str, degree: int,
                        transcript: Transcript, label: bytes):
    """Device-transcript form of prove_custom, SPARK's: the host transcript
    continues on the tables' device and every round runs there as one
    ``custom_round_fs`` (K5 binds the previous challenge from device
    memory, evaluates, absorbs the values into the transcript and squeezes
    the next challenge), the evaluations and challenges going into
    preallocated buffers; the bare final bind is a plain K5 launch.  One
    packed fetch brings the evaluations and the final table values back,
    with no host sync between (``OTTI_SYNC_CHECK=1``).  The host then
    replays the rounds into ``transcript``: the same bytes as prove_custom,
    so verify_custom is unchanged.  The host transcript must sit at the
    post-challenge offsets (every SPARK call site follows a
    challenge_vector), where every round's transcript step starts and ends.
    The JAX package's segments and shrinks (``_CUSTOM_SEG``,
    ``_shrink_kernel``) save it compile time and have no counterpart here:
    K5 only ever reads the active prefix of the tables."""
    from .hybrid import _check_handoff, _fetch_packed, _no_host_sync

    stacked, cst = _working_copy(tables, consts)
    n = stacked.shape[1]
    mu = (n - 1).bit_length()
    device = stacked.device
    t = _check_handoff([transcript], device)
    prog = round_program(label, degree, device) if mu else None
    with _no_host_sync(device):
        evals_all = torch.empty((mu, degree, N_LIMBS), dtype=torch.int32, device=device)
        rs_dev = torch.empty((mu, N_LIMBS), dtype=torch.int32, device=device)
        for j in range(mu):
            custom_round_fs(stacked, cst, key, degree, t.strobe.state, prog, evals_all[j],
                            rs_dev[j], rs_dev[j - 1] if j else None, n >> j if j else None)
        if mu:
            custom_round(stacked, cst, key, degree, rs_dev[mu - 1], 1)
        finals_dev = F.canon(SCALAR, stacked[:, 0])
    (evals_np, finals_np), _ = _fetch_packed([evals_all, finals_dev], [])

    # host replay: the absorb and challenge stream of prove_custom
    e = claim % MOD
    rounds, rs = [], []
    for row in evals_np:
        evals, r, e = _absorb_round(e, [limbs_to_int(x) for x in row], transcript, label)
        rounds.append(evals)
        rs.append(r)
    finals = tuple(limbs_to_int(x) for x in finals_np)
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
