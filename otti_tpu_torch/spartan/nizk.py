"""Transparent Spartan NIZK for R1CS (port of otti_tpu/spartan/nizk.py).

Prover: Hyrax row commitments of the witness (fixed-base comb MSM) ->
phase-1 cubic sumcheck on eq (Az Bz - Cz) -> phase-2 quadratic sumcheck on
M Z -> Hyrax row combination on the device and the log-sized bullet
opening on the host.  The verifier evaluates the sparse matrices itself.
Bulk math runs on the device of the ``R1CSDevice``; the Merlin transcript
and the O(mu) bookkeeping run on the host.  The labels, the schedule and
the wire format are the JAX package's: for the same instance both packages
produce byte-identical proofs, and each verifier accepts the other's.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import metrics
from ..field.fields import SCALAR
from ..native import msm_host, ristretto_decode_host
from ..transcript.merlin import Transcript

from ..field import ops as F
from . import bullet, commitments, mle, r1cs, sumcheck

MOD = SCALAR.modulus
PROTO = b"otti-tpu Spartan NIZK v1"
GENS_LABEL = b"gens_pc"


def _sb(x: int) -> bytes:
    return (x % MOD).to_bytes(32, "little")


def _vec(xs, device) -> torch.Tensor:
    return F.from_ints(SCALAR, xs, device)


def _eq_weights(r: list) -> list:
    """eq table of a challenge list as host ints (r[0] = MSB of the index)."""
    out = [1]
    for rj in r:
        nxt = []
        for x in out:
            nxt.append(x * ((1 - rj) % MOD) % MOD)
            nxt.append(x * rj % MOD)
        out = nxt
    return out


def _eq_point(a: list, b: list) -> int:
    """eq(a, b) = prod_i (a_i b_i + (1-a_i)(1-b_i))."""
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((x * y + (1 - x) * (1 - y)) % MOD) % MOD
    return acc


def _mle_eval_host(vals: list, r: list) -> int:
    """Evaluate the MLE of ``vals`` (len 2^mu, MSB-first index) at r."""
    mu = len(r)
    assert len(vals) == 1 << mu
    cur = [v % MOD for v in vals]
    for j in range(mu):
        half = len(cur) // 2
        rj = r[j] % MOD
        cur = [(cur[i] + rj * (cur[half + i] - cur[i])) % MOD for i in range(half)]
    return cur[0]


@dataclasses.dataclass
class NIZKProof:
    comm_vars: list  # row commitment encodings (bytes32 each)
    phase1_polys: list  # per-round [e0,e1,e2,e3]
    claims_abc: tuple  # (vA, vB, vC)
    phase2_polys: list  # per-round [e0,e1,e2]
    claim_w: int  # claimed W(ry[1:])
    bullet: object  # log-sized Hyrax opening (bullet.BulletOpeningProof)

    def size_bytes(self) -> int:
        n_scalars = (
            sum(len(p) for p in self.phase1_polys)
            + sum(len(p) for p in self.phase2_polys)
            + 4
        )
        return 32 * (n_scalars + len(self.comm_vars)) + self.bullet.size_bytes()


def _hyrax_dims(num_vars_padded: int):
    mu = (num_vars_padded - 1).bit_length() if num_vars_padded > 1 else 0
    mu_cols = (mu + 1) // 2
    return mu - mu_cols, mu_cols


def _row_combine(W: torch.Tensor, r_rows: list) -> torch.Tensor:
    """u[c] = sum_r eq(r_rows)[r] * W[r, c] for a Hyrax matrix [rows, cols, 22]
    (no row variable: the one row itself)."""
    eq_L = mle.eq_table(_vec(r_rows, W.device))
    return F.sum_reduce(SCALAR, F.mul(SCALAR, eq_L[:, None, :], W), axis=0)


def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list,
          proto: bytes = PROTO) -> NIZKProof:
    device = dev.device
    t = Transcript(proto)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))

    nvp = dev.num_vars
    metrics.add("constraints", dev.num_cons)
    mu_rows, mu_cols = _hyrax_dims(nvp)
    vars_padded = list(vars_ints) + [0] * (nvp - len(vars_ints))
    w_flat = _vec(vars_padded, device)
    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    with metrics.timed("commit"):
        comm_enc = commitments.encode_points(
            commitments.commit_rows(W, [0] * W.shape[0], GENS_LABEL))
    metrics.add("msm_points", nvp)
    for enc in comm_enc:
        t.append_point(b"poly_commitment", enc)

    # ---- phase 1 ----------------------------------------------------------
    mu_x = (dev.num_cons - 1).bit_length()
    tau = t.challenge_vector(b"challenge_tau", mu_x)
    z = r1cs.assemble_z(w_flat, _vec(inputs_ints, device) if inputs_ints else None, nvp)
    eq_tau = mle.eq_table(_vec(tau, device))
    with metrics.timed("matvec"):
        az, bz, cz = dev.matvecs(z)
    with metrics.timed("sumcheck1"):
        p1, rx, (_, vA, vB, vC), _ = sumcheck.prove_cubic(0, eq_tau, az, bz, cz, t, b"sc1")
    metrics.add("sumcheck_rounds", mu_x)
    t.append_scalar(b"vA", _sb(vA))
    t.append_scalar(b"vB", _sb(vB))
    t.append_scalar(b"vC", _sb(vC))

    # ---- phase 2 ----------------------------------------------------------
    r_a = t.challenge_scalar(b"challenge_Az")
    r_b = t.challenge_scalar(b"challenge_Bz")
    r_c = t.challenge_scalar(b"challenge_Cz")
    claim2 = (r_a * vA + r_b * vB + r_c * vC) % MOD
    e_rx = mle.eq_table(_vec(rx, device))
    m_table = dev.matvec_T_weighted(tuple(_vec([x], device)[0] for x in (r_a, r_b, r_c)), e_rx)
    with metrics.timed("sumcheck2"):
        p2, ry, _, _ = sumcheck.prove_quad(claim2, m_table, z, t, b"sc2")

    # ---- witness opening at ry[1:] ---------------------------------------
    # Z(y) = (1-y0) W(y_1..) + y0 IO(y_1..): prove W(ry[1:]) with the Hyrax
    # rows and the bullet argument on the row combination u = L^T W.
    with metrics.timed("opening"):
        r_w = ry[1:]
        u_ints = F.to_ints(SCALAR, _row_combine(W, r_w[:mu_rows]))
        claim_w = _mle_eval_host(vars_padded, r_w)
        t.append_scalar(b"claim_w", _sb(claim_w))
        proof_bullet = _prove_opening(t, mu_rows, mu_cols, r_w, u_ints)

    return NIZKProof(
        comm_vars=comm_enc,
        phase1_polys=p1,
        claims_abc=(vA, vB, vC),
        phase2_polys=p2,
        claim_w=claim_w,
        bullet=proof_bullet,
    )


def _prove_opening(t, mu_rows, mu_cols, r_w, u_ints):
    """Bullet argument for <u, eq_R(r_w)> == claim_w, all blinds zero."""
    R = _eq_weights(r_w[mu_rows:])
    G, H = commitments.gen_points_host(1 << mu_cols, GENS_LABEL)
    Q = bullet.q_point_host(GENS_LABEL)
    return bullet.prove(t, list(G), H, Q, u_ints, R, 0, rng=None)


def _verify_opening(t, mu_rows, mu_cols, r_w, comm_vars, claim_w, proof_bullet):
    if len(comm_vars) != (1 << mu_rows):
        return False
    Lw = _eq_weights(r_w[:mu_rows])
    rows_pts = [ristretto_decode_host(enc) for enc in comm_vars]
    if any(p is None for p in rows_pts):
        return False
    G, H = commitments.gen_points_host(1 << mu_cols, GENS_LABEL)
    Q = bullet.q_point_host(GENS_LABEL)
    P = msm_host(rows_pts + [Q], Lw + [claim_w % MOD])
    R = _eq_weights(r_w[mu_rows:])
    return bullet.verify(t, list(G), H, Q, R, P, proof_bullet)


def verify(dev: r1cs.R1CSDevice, inputs_ints: list, proof) -> bool:
    """Accepts a proof of either package (same fields)."""
    try:
        return _verify_inner(dev, inputs_ints, proof)
    except (ValueError, AssertionError):
        return False


def _verify_inner(dev: r1cs.R1CSDevice, inputs_ints: list, proof) -> bool:
    device = dev.device
    t = Transcript(PROTO)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))
    for enc in proof.comm_vars:
        t.append_point(b"poly_commitment", enc)

    mu_x = (dev.num_cons - 1).bit_length()
    tau = t.challenge_vector(b"challenge_tau", mu_x)
    e1, rx = sumcheck.verify_rounds(0, proof.phase1_polys, 3, t, b"sc1")
    vA, vB, vC = proof.claims_abc
    t.append_scalar(b"vA", _sb(vA))
    t.append_scalar(b"vB", _sb(vB))
    t.append_scalar(b"vC", _sb(vC))
    if _eq_point(tau, rx) * ((vA * vB - vC) % MOD) % MOD != e1:
        return False

    r_a = t.challenge_scalar(b"challenge_Az")
    r_b = t.challenge_scalar(b"challenge_Bz")
    r_c = t.challenge_scalar(b"challenge_Cz")
    claim2 = (r_a * vA + r_b * vB + r_c * vC) % MOD
    e2, ry = sumcheck.verify_rounds(claim2, proof.phase2_polys, 2, t, b"sc2")
    t.append_scalar(b"claim_w", _sb(proof.claim_w))

    nvp = dev.num_vars
    mu_rows, mu_cols = _hyrax_dims(nvp)
    r_w = ry[1:]
    if not _verify_opening(t, mu_rows, mu_cols, r_w, proof.comm_vars, proof.claim_w,
                           proof.bullet):
        return False

    # final phase-2 identity: e2 == M(ry) * Z(ry)
    io = [1] + list(inputs_ints) + [0] * (nvp - 1 - len(inputs_ints))
    v_io = _mle_eval_host(io, r_w)
    v_z = ((1 - ry[0]) * proof.claim_w + ry[0] * v_io) % MOD
    e_rx = mle.eq_table(_vec(rx, device))
    e_ry = mle.eq_table(_vec(ry, device))
    ea, eb, ec = (F.to_int(SCALAR, v) for v in dev.eval_at(e_rx, e_ry))
    v_m = (r_a * ea + r_b * eb + r_c * ec) % MOD
    return (v_m * v_z) % MOD == e2
