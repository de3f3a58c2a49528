# copied from otti_tpu/spartan/wire.py
"""Wire-format profiles: the native otti-tpu schedule and an
upstream-Spartan-compatible label schedule (VERDICT r02 missing #1).

BASELINE.md's end-to-end target includes "bit-identical verification
against reference Spartan/spartan-zkinterface vectors".  The primitive
layer is already dalek/merlin-bit-exact (ristretto encodings, 32-byte LE
scalars, STROBE framing — vector-validated in tests/test_transcript.py
and tests/test_curve.py); what differed was the transcript LABEL
schedule and a few structural choices.  This module makes the schedule a
config object so the ZK NIZK path can emit either:

  * ``OTTI``    — this framework's canonical labels (default; what every
    device-FS prover speaks),
  * ``SPARTAN`` — the upstream microsoft/Spartan label vocabulary, as
    reconstructed from the upstream sources (SURVEY.md §2.2 "Spartan"
    row is [reconstructed]: the reference snapshot ships no Spartan
    code).  Each label below is annotated with its upstream source
    location; byte-level cross-validation requires a Rust toolchain that
    this environment does not have, so the profile is exactly the single
    table to adjust the day one is available (docs/PROTOCOL.md).

Upstream structural notes honored by the SPARTAN profile:
  * the two claim-combination weights are drawn as ONE 2-element
    challenge vector (src/sumcheck.rs: ``challenge_vector(
    b"combine_two_claims_to_one", 2)``), not two scalar draws;
  * the per-round running-claim commitment label is
    ``comm_claim_per_round`` and the round challenge is
    ``challenge_nextround`` (src/sumcheck.rs);
  * claim commitments after phase 1 use ``comm_Az_claim`` /
    ``comm_Bz_claim`` / ``comm_Cz_claim`` / ``comm_prod_Az_Bz_claims``
    (src/r1csproof.rs).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WireProfile:
    name: str
    proto: bytes  # transcript protocol label
    r1cs_digest: bytes  # label binding the instance digest
    input: bytes
    poly_commitment: bytes
    challenge_tau: bytes
    # per-round zk-sumcheck labels; {sc} is the phase prefix for the otti
    # profile and empty for spartan (upstream has one global namespace)
    sc_comm_poly: bytes
    sc_challenge: bytes
    sc_comm_eval: bytes
    # how the two claim-combination weights are drawn:
    #   "scalars" -> two challenge_scalar draws labelled sc_w0 / sc_w1
    #   "vector"  -> one challenge_vector(sc_w0, 2) draw
    w_mode: str
    sc_w0: bytes
    sc_w1: bytes
    phase_prefix: bool  # prefix round labels with the phase label (b"sc1")
    comm_A: bytes
    comm_B: bytes
    comm_C: bytes
    comm_AB: bytes
    challenge_Az: bytes
    challenge_Bz: bytes
    challenge_Cz: bytes

    # -- helpers -----------------------------------------------------------
    def rl(self, phase: bytes, leaf: bytes) -> bytes:
        """Round label: phase-scoped for otti, global for spartan."""
        return (phase + b"/" + leaf) if self.phase_prefix else leaf

    def draw_weights(self, transcript, phase: bytes):
        if self.w_mode == "vector":
            w = transcript.challenge_vector(self.rl(phase, self.sc_w0), 2)
            return w[0], w[1]
        w0 = transcript.challenge_scalar(self.rl(phase, self.sc_w0))
        w1 = transcript.challenge_scalar(self.rl(phase, self.sc_w1))
        return w0, w1


OTTI = WireProfile(
    name="otti",
    proto=b"otti-tpu Spartan zkNIZK v1",
    r1cs_digest=b"R1CS",
    input=b"input",
    poly_commitment=b"poly_commitment",
    challenge_tau=b"challenge_tau",
    sc_comm_poly=b"comm_poly",
    sc_challenge=b"r",
    sc_comm_eval=b"comm_eval",
    w_mode="scalars",
    sc_w0=b"w0",
    sc_w1=b"w1",
    phase_prefix=True,
    comm_A=b"CA",
    comm_B=b"CB",
    comm_C=b"CC",
    comm_AB=b"Cab",
    challenge_Az=b"challenge_Az",
    challenge_Bz=b"challenge_Bz",
    challenge_Cz=b"challenge_Cz",
)

SPARTAN = WireProfile(
    name="spartan",
    # NIZK::protocol_name(), src/nizk/mod.rs [reconstructed]
    proto=b"Spartan NIZK proof",
    # NIZK::prove appends the instance digest, src/nizk/mod.rs
    r1cs_digest=b"R1CSInstanceDigest",
    input=b"input",
    # PolyCommitment::append_to_transcript, src/dense_mlpoly.rs
    poly_commitment=b"poly_commitment",
    # R1CSProof::prove, src/r1csproof.rs
    challenge_tau=b"challenge_tau",
    # ZKSumcheckInstanceProof, src/sumcheck.rs
    sc_comm_poly=b"comm_poly",
    sc_challenge=b"challenge_nextround",
    sc_comm_eval=b"comm_claim_per_round",
    w_mode="vector",
    sc_w0=b"combine_two_claims_to_one",
    sc_w1=b"",  # unused in vector mode
    phase_prefix=False,
    # src/r1csproof.rs claim commitments
    comm_A=b"comm_Az_claim",
    comm_B=b"comm_Bz_claim",
    comm_C=b"comm_Cz_claim",
    comm_AB=b"comm_prod_Az_Bz_claims",
    challenge_Az=b"challenge_Az",
    challenge_Bz=b"challenge_Bz",
    challenge_Cz=b"challenge_Cz",
)

PROFILES = {"otti": OTTI, "spartan": SPARTAN}
