"""Spartan SNARK mode: preprocessing commitments to A, B, C and SPARK
evaluation proofs (port of otti_tpu/spartan/snark.py).

The NIZK verifier evaluates the sparse matrices itself in O(nnz).  SNARK
mode moves that work to the prover: the matrices are committed once
(``spark.commit``), and each proof carries the claimed evaluations
(eA, eB, eC) at (rx, ry) with a SPARK evaluation proof tying them to the
commitment.  Everything else is the plain NIZK under this mode's protocol
label.
"""

from __future__ import annotations

import dataclasses

from ..field.fields import SCALAR
from ..transcript.merlin import Transcript

from .. import metrics
from ..field import ops as F
from . import bullet, mle, nizk, r1cs, spark, sumcheck
from .nizk import MOD, _sb

PROTO = b"otti-tpu Spartan SNARK v1"


@dataclasses.dataclass
class SNARKProof:
    base: nizk.NIZKProof
    evals_abc: tuple  # claimed (eA, eB, eC) at (rx, ry)
    spark_proof: spark.SparkEvalProof  # combined A/B/C eval proof

    def size_bytes(self) -> int:
        def count(o):
            if isinstance(o, (bytes, int)):
                return 32
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                return sum(count(getattr(o, f.name)) for f in dataclasses.fields(o))
            if isinstance(o, (list, tuple)):
                return sum(count(v) for v in o)
            if isinstance(o, dict):
                return sum(count(v) for v in o.values())
            return 0

        return count(self)


def prove(dev: r1cs.R1CSDevice, comm: spark.SparkCommitment, vars_ints: list,
          inputs_ints: list) -> SNARKProof:
    base = nizk.prove(dev, vars_ints, inputs_ints, proto=PROTO)

    # reconstruct (rx, ry) by replaying the transcript, then prove evals
    t = _replay_transcript(dev, inputs_ints, base)
    rx, ry = _replay_points(dev, base, t)

    with metrics.timed("matrix_eval"):
        e_rx = mle.eq_table(nizk._vec(rx, dev.device))
        e_ry = mle.eq_table(nizk._vec(ry, dev.device))
        ea, eb, ec = (F.to_int(SCALAR, v) for v in dev.eval_at(e_rx, e_ry))
    for lbl, v in ((b"eval_A", ea), (b"eval_B", eb), (b"eval_C", ec)):
        t.append_scalar(lbl, _sb(v))

    sp = spark.prove_eval(comm, rx, ry, (ea, eb, ec), t, b"spark")
    return SNARKProof(base=base, evals_abc=(ea, eb, ec), spark_proof=sp)


def _replay_transcript(dev, inputs_ints, base) -> Transcript:
    t = Transcript(PROTO)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))
    for enc in base.comm_vars:
        t.append_point(b"poly_commitment", enc)
    return t


def _replay_points(dev, base, t):
    mu_x = (dev.num_cons - 1).bit_length()
    t.challenge_vector(b"challenge_tau", mu_x)
    _, rx = sumcheck.verify_rounds(0, base.phase1_polys, 3, t, b"sc1")
    vA, vB, vC = base.claims_abc
    t.append_scalar(b"vA", _sb(vA))
    t.append_scalar(b"vB", _sb(vB))
    t.append_scalar(b"vC", _sb(vC))
    r_a = t.challenge_scalar(b"challenge_Az")
    r_b = t.challenge_scalar(b"challenge_Bz")
    r_c = t.challenge_scalar(b"challenge_Cz")
    claim2 = (r_a * vA + r_b * vB + r_c * vC) % MOD
    _, ry = sumcheck.verify_rounds(claim2, base.phase2_polys, 2, t, b"sc2")
    t.append_scalar(b"claim_w", _sb(base.claim_w))
    _, mu_cols = nizk._hyrax_dims(dev.num_vars)
    bullet.replay(t, base.bullet, 1 << mu_cols)
    return rx, ry


def verify(dev: r1cs.R1CSDevice, comm: spark.SparkCommitment, inputs_ints: list,
           proof: SNARKProof) -> bool:
    """Accepts a proof of either package (same fields).  Reads of ``dev``
    only its sizes and digest, never the matrices."""
    try:
        return _verify_inner(dev, comm, inputs_ints, proof)
    except (ValueError, AssertionError):
        return False


def _verify_inner(dev, comm, inputs_ints, proof) -> bool:
    base = proof.base
    t = _replay_transcript(dev, inputs_ints, base)

    mu_x = (dev.num_cons - 1).bit_length()
    tau = t.challenge_vector(b"challenge_tau", mu_x)
    e1, rx = sumcheck.verify_rounds(0, base.phase1_polys, 3, t, b"sc1")
    vA, vB, vC = base.claims_abc
    t.append_scalar(b"vA", _sb(vA))
    t.append_scalar(b"vB", _sb(vB))
    t.append_scalar(b"vC", _sb(vC))
    if nizk._eq_point(tau, rx) * ((vA * vB - vC) % MOD) % MOD != e1:
        return False
    r_a = t.challenge_scalar(b"challenge_Az")
    r_b = t.challenge_scalar(b"challenge_Bz")
    r_c = t.challenge_scalar(b"challenge_Cz")
    claim2 = (r_a * vA + r_b * vB + r_c * vC) % MOD
    e2, ry = sumcheck.verify_rounds(claim2, base.phase2_polys, 2, t, b"sc2")
    t.append_scalar(b"claim_w", _sb(base.claim_w))

    # Hyrax witness opening by the log-sized bullet argument (as the NIZK)
    nvp = dev.num_vars
    mu_rows, mu_cols = nizk._hyrax_dims(nvp)
    r_w = ry[1:]
    if not nizk._verify_opening(t, mu_rows, mu_cols, r_w, base.comm_vars, base.claim_w,
                                base.bullet):
        return False

    # the SNARK's difference: the matrix evaluations come from the proof + SPARK
    ea, eb, ec = proof.evals_abc
    for lbl, v in ((b"eval_A", ea), (b"eval_B", eb), (b"eval_C", ec)):
        t.append_scalar(lbl, _sb(v))
    if not spark.verify_eval(comm, rx, ry, (ea, eb, ec), proof.spark_proof, t, b"spark"):
        return False

    io = [1] + list(inputs_ints) + [0] * (nvp - 1 - len(inputs_ints))
    v_io = nizk._mle_eval_host(io, r_w)
    ry0 = ry[0]
    v_z = ((1 - ry0) * base.claim_w + ry0 * v_io) % MOD
    v_m = (r_a * ea + r_b * eb + r_c * ec) % MOD
    return (v_m * v_z) % MOD == e2
