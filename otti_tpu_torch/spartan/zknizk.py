"""Zero-knowledge Spartan NIZK (port of otti_tpu/spartan/zknizk.py).

Assembles the ZK sumchecks (zksumcheck.py), the sigma toolbox (sigma.py)
and blinded Hyrax row commitments into the complete argument: nothing
about the witness is revealed beyond R1CS satisfiability.  Claims,
matrix-evaluation values and the opening combination all travel as
Pedersen commitments with Schnorr-style consistency proofs.

Protocol (labels come from a wire profile, spartan/wire.py):
  1. commit witness rows with blinds (device comb MSM)  -> comm_vars
  2. tau <- FS;  ZK sumcheck #1 on eq*(Az*Bz - Cz), claim 0
  3. commit vA, vB, vC;  ProductProof for vA*vB;
     EqualityProof: e1_final == eq(tau, rx) * (vAB - vC)
  4. rA, rB, rC <- FS;  committed claim2 = rA*CA + rB*CB + rC*CC
     ZK sumcheck #2 on M * Z
  5. commit w_eval = W(ry[1:]);  bullet argument: <u, eq_R> = w_eval
     against C_u = sum_i L_i * comm_vars_i  (Hyrax opening, blinds fold)
  6. EqualityProof: e2_final == M(ry) * ((1-ry0)*w_eval + ry0*v_io)

Bulk math (row commitments, sparse products, eq tables, both sumchecks,
the row combination) runs on the device of the ``R1CSDevice``; the Merlin
transcript, the Pedersen commitments of single values and the sigma proofs
run on the host.  Labels, the order in which blinds are drawn and the wire
format are the JAX package's: for one instance and one ``seed`` both
packages produce byte-identical proofs, and each verifier accepts the
other's.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .. import metrics
from ..field.fields import SCALAR
from ..native import msm_host
from ..refimpl import numeric as ref
from ..transcript.merlin import Transcript

from ..field import ops as F
from . import bullet, commitments, mle, r1cs, sigma, zksumcheck
from .nizk import (
    GENS_LABEL,
    _eq_point,
    _eq_weights,
    _hyrax_dims,
    _mle_eval_host,
    _row_combine,
    _sb,
    _vec,
)
from .pedersen_host import BlindSource, Gens, commit, decode
from .wire import OTTI, PROFILES

L = ref.L
PROTO = b"otti-tpu Spartan zkNIZK v1"


@dataclasses.dataclass
class ZKNIZKProof:
    comm_vars: list  # blinded row commitments (bytes32)
    sc1: zksumcheck.ZKSumcheckProof
    comm_abc: tuple  # (CA, CB, CC) bytes32
    comm_ab: bytes  # commitment to vA*vB
    proof_ab: sigma.ProductProof
    eq1: sigma.EqualityProof
    sc2: zksumcheck.ZKSumcheckProof
    comm_w: bytes  # commitment to W(ry[1:]) under base G0 (for eq2)
    comm_wq: bytes  # same value under base Q (for the bullet opening)
    base_eq: sigma.DualBaseEqualityProof  # comm_w == comm_wq in value
    bullet: object  # log-sized blinded opening (bullet.BulletOpeningProof)
    eq2: sigma.EqualityProof

    # copied from otti_tpu/spartan/zknizk.py::ZKNIZKProof.size_bytes
    def size_bytes(self) -> int:
        pts = (
            len(self.comm_vars)
            + len(self.sc1.comm_polys) * 2
            + len(self.sc2.comm_polys) * 2
            + 3
            + 1
            + 1
            + 3  # product proof points
            + 2  # equality alphas
            + 2  # comm_w + comm_wq
            + 2  # base_eq alpha/beta
        )
        scalars = (
            sum(len(d.z) + 2 for d in self.sc1.dot_proofs)
            + sum(len(d.z) + 2 for d in self.sc2.dot_proofs)
            + 5
            + 1
            + 3  # base_eq z's
            + 1
        )
        return 32 * (pts + scalars) + self.bullet.size_bytes()


def _max_gens(dev: r1cs.R1CSDevice) -> int:
    _, mu_cols = _hyrax_dims(dev.num_vars)
    return max(1 << mu_cols, 4)


def _wire(wire):
    return PROFILES[wire] if isinstance(wire, str) else (wire or OTTI)


def _absorb_instance(t: Transcript, wire, dev: r1cs.R1CSDevice, inputs_ints: list) -> None:
    t.append_message(wire.r1cs_digest, dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(wire.input, _sb(x))


def _matrix_eval(dev: r1cs.R1CSDevice, e_rx, ry: list, r_abc: tuple) -> int:
    """rA A~(rx, ry) + rB B~(rx, ry) + rC C~(rx, ry): sparse products on the
    device, one fetch."""
    e_ry = mle.eq_table(_vec(ry, dev.device))
    evals = F.to_ints(SCALAR, torch.stack(dev.eval_at(e_rx, e_ry)))
    return sum(r * v for r, v in zip(r_abc, evals)) % L


def prove(
    dev: r1cs.R1CSDevice,
    vars_ints: list,
    inputs_ints: list,
    seed: bytes | None = None,
    wire=None,
) -> ZKNIZKProof:
    """``seed``: 32 bytes from which every blind is drawn (fresh randomness
    when None: proofs are then randomised).  ``wire``: a wire.WireProfile
    (or its name) selecting the transcript label schedule, "otti" (default)
    or "spartan" (see spartan/wire.py)."""
    device = dev.device
    wire = _wire(wire)
    rng = BlindSource(seed or os.urandom(32))
    gens = Gens(_max_gens(dev), GENS_LABEL)

    t = Transcript(wire.proto)
    _absorb_instance(t, wire, dev, inputs_ints)

    nvp = dev.num_vars
    metrics.add("constraints", dev.num_cons)
    mu_rows, mu_cols = _hyrax_dims(nvp)
    vars_padded = list(vars_ints) + [0] * (nvp - len(vars_ints))
    w_flat = _vec(vars_padded, device)
    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    row_blinds = rng.scalars(1 << mu_rows)
    with metrics.timed("commit"):
        comm_enc = commitments.encode_points(
            commitments.commit_rows(W, row_blinds, GENS_LABEL))
    metrics.add("msm_points", nvp)
    for enc in comm_enc:
        t.append_point(wire.poly_commitment, enc)

    # ---- phase 1 (ZK) -----------------------------------------------------
    mu_x = (dev.num_cons - 1).bit_length()
    tau = t.challenge_vector(wire.challenge_tau, mu_x)
    z = r1cs.assemble_z(w_flat, _vec(inputs_ints, device) if inputs_ints else None, nvp)
    eq_tau = mle.eq_table(_vec(tau, device))
    with metrics.timed("matvec"):
        az, bz, cz = dev.matvecs(z)
    with metrics.timed("sumcheck1"):
        sc1, rx, (_, vA, vB, vC), e1, be1 = zksumcheck.prove_zk(
            3, 0, 0, (eq_tau, az, bz, cz), t, b"sc1", gens, rng, wire=wire
        )
    metrics.add("sumcheck_rounds", mu_x)

    # commitments to the matrix evaluations + product + final relation
    with metrics.timed("sigma"):
        bA, bB, bC = rng.scalars(3)
        CA, CB, CC = (commit(v, b, gens) for v, b in ((vA, bA), (vB, bB), (vC, bC)))
        for lbl, C in ((wire.comm_A, CA), (wire.comm_B, CB), (wire.comm_C, CC)):
            t.append_point(lbl, C.ristretto_encode())
        b_ab = rng.scalar()
        if wire.name != "otti":
            # upstream absorbs the product-claim commitment explicitly
            # before the product proof
            C_ab_pre = commit(vA * vB % L, b_ab, gens)
            t.append_point(wire.comm_AB, C_ab_pre.ristretto_encode())
        proof_ab, _, _, C_ab = sigma.ProductProof.prove(t, gens, vA, bA, vB, bB, b_ab, rng)
        # e1 == eq(tau, rx) * (vA*vB - vC); the commitment to the right side
        # is eq * (C_ab - CC), with blind eq * (b_ab - bC)
        eq_val = _eq_point(tau, rx)
        eq1_proof, _, _ = sigma.EqualityProof.prove(
            t, gens, e1, be1, eq_val * (b_ab - bC) % L, rng
        )

    # ---- phase 2 (ZK) -----------------------------------------------------
    r_abc = (
        t.challenge_scalar(wire.challenge_Az),
        t.challenge_scalar(wire.challenge_Bz),
        t.challenge_scalar(wire.challenge_Cz),
    )
    claim2 = sum(r * v for r, v in zip(r_abc, (vA, vB, vC))) % L
    bclaim2 = sum(r * b for r, b in zip(r_abc, (bA, bB, bC))) % L
    e_rx = mle.eq_table(_vec(rx, device))
    m_table = dev.matvec_T_weighted(tuple(_vec([x], device)[0] for x in r_abc), e_rx)
    with metrics.timed("sumcheck2"):
        sc2, ry, _, e2, be2 = zksumcheck.prove_zk(
            2, claim2, bclaim2, (m_table, z), t, b"sc2", gens, rng, wire=wire
        )

    # ---- Hyrax opening (ZK, log-sized) + final relation -------------------
    with metrics.timed("opening"):
        r_w = ry[1:]
        u_ints = F.to_ints(SCALAR, _row_combine(W, r_w[:mu_rows]))
        L_weights = _eq_weights(r_w[:mu_rows])
        b_u = sum(li * bi for li, bi in zip(L_weights, row_blinds)) % L
        w_eval = _mle_eval_host(vars_padded, r_w)
        v_m = _matrix_eval(dev, e_rx, ry, r_abc)
        enc_w, enc_wq, base_eq, proof_bullet, eq2_proof = _opening_and_final_zk(
            t, gens, mu_cols, u_ints, b_u, w_eval,
            _eq_weights(r_w[mu_rows:]), v_m, ry[0], e2, be2, rng,
        )

    return ZKNIZKProof(
        comm_vars=comm_enc,
        sc1=sc1,
        comm_abc=(CA.ristretto_encode(), CB.ristretto_encode(), CC.ristretto_encode()),
        comm_ab=C_ab.ristretto_encode(),
        proof_ab=proof_ab,
        eq1=eq1_proof,
        sc2=sc2,
        comm_w=enc_w,
        comm_wq=enc_wq,
        base_eq=base_eq,
        bullet=proof_bullet,
        eq2=eq2_proof,
    )


def _opening_and_final_zk(
    t, gens, mu_cols, u_ints, b_u, w_eval, R_weights, v_m, ry0, e2, be2, rng
):
    """Blinded log-sized opening + final-relation proof (host tail):
      1. commit w_eval under G0 (comm_w, feeds eq2) and under Q (comm_wq);
         DualBaseEqualityProof ties the two.
      2. bullet argument on P = C_u + comm_wq with blind b_u + b_wq:
         <u, eq_R> == w_eval, where C_u = sum_i L_i * comm_vars_i.
      3. EqualityProof: e2 == v_m * ((1-ry0)*w_eval + ry0*v_io).
    """
    Q = bullet.q_point_host(GENS_LABEL)
    b_w = rng.scalar()
    b_wq = rng.scalar()
    C_w = commit(w_eval, b_w, gens)
    C_wq = msm_host([Q, gens.H], [w_eval % L, b_wq % L])
    base_eq, _, _ = sigma.DualBaseEqualityProof.prove(
        t, gens.G[0], Q, gens.H, w_eval, b_w, b_wq, rng
    )
    proof_bullet = bullet.prove(
        t, list(gens.G[: 1 << mu_cols]), gens.H, Q, u_ints, R_weights, (b_u + b_wq) % L, rng,
    )
    coeff_w = v_m * (1 - ry0) % L
    eq2_proof, _, _ = sigma.EqualityProof.prove(t, gens, e2, be2, coeff_w * b_w % L, rng)
    return C_w.ristretto_encode(), C_wq.ristretto_encode(), base_eq, proof_bullet, eq2_proof


def verify(dev: r1cs.R1CSDevice, inputs_ints: list, proof, wire=None) -> bool:
    """Accepts a proof of either package (same fields)."""
    try:
        return _verify_inner(dev, inputs_ints, proof, wire)
    except (ValueError, AssertionError):
        return False


def _verify_inner(dev, inputs_ints, proof, wire=None) -> bool:
    device = dev.device
    wire = _wire(wire)
    gens = Gens(_max_gens(dev), GENS_LABEL)
    t = Transcript(wire.proto)
    _absorb_instance(t, wire, dev, inputs_ints)
    for enc in proof.comm_vars:
        t.append_point(wire.poly_commitment, enc)

    nvp = dev.num_vars
    mu_rows, mu_cols = _hyrax_dims(nvp)
    if len(proof.comm_vars) != (1 << mu_rows):
        return False

    mu_x = (dev.num_cons - 1).bit_length()
    tau = t.challenge_vector(wire.challenge_tau, mu_x)

    # phase 1
    C_zero = commit(0, 0, gens)
    rx, C_e1 = zksumcheck.verify_zk(3, proof.sc1, C_zero, mu_x, t, b"sc1", gens, wire=wire)

    CA, CB, CC = (decode(b) for b in proof.comm_abc)
    for lbl, enc in zip((wire.comm_A, wire.comm_B, wire.comm_C), proof.comm_abc):
        t.append_point(lbl, enc)
    C_ab = decode(proof.comm_ab)
    if wire.name != "otti":
        t.append_point(wire.comm_AB, proof.comm_ab)
    if not proof.proof_ab.verify(t, gens, CA, CB, C_ab):
        return False
    eq_val = _eq_point(tau, rx)
    C_rhs = (C_ab + (-CC)) * eq_val
    if not proof.eq1.verify(t, gens, C_e1, C_rhs):
        return False

    r_abc = (
        t.challenge_scalar(wire.challenge_Az),
        t.challenge_scalar(wire.challenge_Bz),
        t.challenge_scalar(wire.challenge_Cz),
    )
    C_claim2 = CA * r_abc[0] + CB * r_abc[1] + CC * r_abc[2]
    mu_y = (dev.num_z - 1).bit_length()
    ry, C_e2 = zksumcheck.verify_zk(2, proof.sc2, C_claim2, mu_y, t, b"sc2", gens, wire=wire)

    # Hyrax opening (log-sized): dual-base tie + bullet argument
    r_w = ry[1:]
    L_weights = _eq_weights(r_w[:mu_rows])
    rows_pts = [decode(enc) for enc in proof.comm_vars]
    C_u = msm_host(rows_pts, L_weights)
    C_w = decode(proof.comm_w)
    C_wq = decode(proof.comm_wq)
    Q = bullet.q_point_host(GENS_LABEL)
    if not proof.base_eq.verify(t, gens.G[0], Q, gens.H, C_w, C_wq):
        return False
    R_weights = _eq_weights(r_w[mu_rows:])
    P = C_u + C_wq
    if not bullet.verify(t, list(gens.G[: 1 << mu_cols]), gens.H, Q, R_weights, P, proof.bullet):
        return False

    # final relation
    io = [1] + list(inputs_ints) + [0] * (nvp - 1 - len(inputs_ints))
    v_io = _mle_eval_host(io, r_w)
    ry0 = ry[0]
    v_m = _matrix_eval(dev, mle.eq_table(_vec(rx, device)), ry, r_abc)
    coeff_w = v_m * (1 - ry0) % L
    const_term = v_m * ry0 % L * v_io % L
    C_rhs2 = C_w * coeff_w + gens.G[0] * const_term
    return bool(proof.eq2.verify(t, gens, C_e2, C_rhs2))
