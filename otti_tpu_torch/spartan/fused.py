"""Device-transcript Spartan NIZK prover, one fetch a proof (port of
otti_tpu/spartan/fused.py).

The classic prover (nizk.py) fetches each sumcheck round's evaluations to
the host, where the Merlin transcript draws the next challenge.  Here the
transcript itself runs on the device (transcript/device.py): the Hyrax
commitment, its ristretto encodings (kernel K4), both sumcheck phases with
every challenge, and the opening materials are enqueued without the host
waiting on the card, and one fetch brings the proof materials back.  The
host then replays the transcript over them to assemble the proof object
(``assemble_plain_proof``, shared with hybrid.py).

Every challenge ends with the sponge at byte 64 of a fresh operation frame
(a 64-byte PRF squeeze after a forced permutation), so every round of a
phase starts at the same offsets, ``POST_CHALLENGE``; the round loop
asserts it.  In the JAX package that periodicity lets a phase compile as
one scan body; here a phase is a Python loop of kernel-2 launches and
transcript ops, and the JAX package's split between this single-dispatch
prover and hybrid.py's phase kernels (made for compile time) has no cost
to save: both provers run the same chain of launches (hybrid.py holds it).
They differ only in the witness commitment, absorbed on the device here
and on the host there.

Wire format and transcript schedule are byte-identical to nizk.prove;
tests/test_torch_device_fs.py asserts proof equality with both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics
from ..curve import ristretto
from ..field import ops as F
from ..field.fields import SCALAR, limbs_to_int
from ..msm import pippenger
from ..transcript.device import POST_CHALLENGE, DeviceTranscript
from ..transcript.merlin import Transcript
from . import commitments, nizk, r1cs, sumcheck
from .sumcheck_kernels import sumcheck_round

MOD = SCALAR.modulus


def _ints(arr: np.ndarray):
    """Canonical limb rows -> python ints (host, after the fetch)."""
    if arr.ndim == 1:
        return limbs_to_int(arr) % MOD
    return [_ints(row) for row in arr]


def _round_scan(t: DeviceTranscript, tables: list, degree: int, label: bytes):
    """All rounds of one sumcheck phase on the device: per round the
    evaluations (kernel 2) are absorbed, the challenge r is squeezed, and
    the next launch of kernel 2 binds r (read from device memory) and
    evaluates the next round.  The tables are bound in place; their row 0
    holds the final values after the last (bare) bind.  Returns (evals
    [mu, 3 or 2, 22], rs [mu, 22]), canonical.  Tables [B, n, 22] with a
    transcript of B states run B instances side by side: (evals [B, mu, 3
    or 2, 22], rs [B, mu, 22])."""
    pts = (0, 2, 3) if degree == 3 else (0, 2)
    labels = [label + b"/e%d" % p for p in pts]
    lead = tuple(tables[0].shape[:-2])
    n = tables[0].shape[-2]
    mu = (n - 1).bit_length()
    if mu == 0:
        dev = tables[0].device
        return F.zeros(lead + (0, len(pts)), dev), F.zeros(lead + (0,), dev)
    evals = sumcheck_round(tables, degree)
    rounds, rs = [], []
    active = n
    for _ in range(mu):
        assert t.strobe.offsets == POST_CHALLENGE, "round not at the post-challenge offsets"
        for i, lbl in enumerate(labels):
            t.append_scalar_limbs(lbl, evals[..., i, :])
        r = t.challenge_scalar_limbs(label + b"/r")
        rounds.append(evals)
        rs.append(r)
        evals = sumcheck_round(tables, degree, r, active // 2)
        active //= 2
    return torch.stack(rounds, dim=len(lead)), torch.stack(rs, dim=len(lead))


def _core(dev: r1cs.R1CSDevice, t: DeviceTranscript, w_flat: torch.Tensor, z: torch.Tensor,
          mu_rows: int, mu_cols: int, tbl_commit: dict) -> tuple:
    """The prover after the instance absorbs, all on the device: the Hyrax
    row commitments and their encodings absorbed, tau squeezed, then the
    chain of hybrid.py.  ``z`` is bound in place by phase 2.  Returns
    (enc [rows, 32], rounds1, vabc, rounds2, u, claim_w)."""
    from .hybrid import _device_chain

    rows = 1 << mu_rows
    W = w_flat.reshape(rows, 1 << mu_cols, -1)
    comm = commitments.commit_rows(W, [0] * rows, nizk.GENS_LABEL, tbl=tbl_commit)
    enc = ristretto.encode(comm)  # [rows, 32]
    for i in range(rows):
        t.append_message(b"poly_commitment", enc[i])
    tau = t.challenge_vector_limbs(b"challenge_tau", (dev.num_cons - 1).bit_length())
    return (enc,) + _device_chain(dev, t, tau, z, w_flat, mu_rows, mu_cols)


@torch.inference_mode()
def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list,
          proto: bytes = nizk.PROTO) -> nizk.NIZKProof:
    """Drop-in replacement for nizk.prove producing byte-identical proofs:
    the host absorbs the instance, the device does everything from the
    witness commitment to the opening materials, and one fetch returns."""
    from .hybrid import _fetch_packed, _no_host_sync

    device = dev.device
    t = Transcript(proto)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", nizk._sb(x))

    nvp = dev.num_vars
    metrics.add("constraints", dev.num_cons)
    metrics.add("msm_points", nvp)
    mu_rows, mu_cols = nizk._hyrax_dims(nvp)
    vars_padded = list(vars_ints) + [0] * (nvp - len(vars_ints))

    # uploads first; then the device chain, with no host sync until the fetch
    w_flat = nizk._vec(vars_padded, device)
    z = r1cs.assemble_z(w_flat, nizk._vec(inputs_ints, device) if inputs_ints else None, nvp)
    tbl_commit = pippenger.fixed_base_tables(1 << mu_cols, nizk.GENS_LABEL, False, device)
    td = DeviceTranscript.from_host(t, device)
    with metrics.timed("fused_prove"):
        with _no_host_sync(device):
            enc, rounds1, vabc, rounds2, u, claim_w = _core(
                dev, td, w_flat, z, mu_rows, mu_cols, tbl_commit)
        (r1_np, vabc_np, r2_np, u_np, cw_np), (enc_np,) = _fetch_packed(
            [rounds1, vabc, rounds2, u, claim_w], [enc])

    mu_x = (dev.num_cons - 1).bit_length()
    metrics.add("sumcheck_rounds", mu_x)
    comm_enc = [bytes(row.tobytes()) for row in enc_np]
    return assemble_plain_proof(
        t, comm_enc, r1_np, vabc_np, r2_np, u_np, cw_np, mu_x, mu_rows, mu_cols)


def assemble_plain_proof(t, comm_enc, r1_np, vabc_np, r2_np, u_np, cw_np, mu_x, mu_rows,
                         mu_cols) -> nizk.NIZKProof:
    """Replay the transcript over device-produced round materials and build
    the NIZKProof (shared by the fused and hybrid provers; the wire format
    and absorb schedule are nizk.prove's)."""
    comm_enc = list(comm_enc)
    for enc in comm_enc:
        t.append_point(b"poly_commitment", enc)
    r1_ints = _ints(np.asarray(r1_np))
    vA, vB, vC = _ints(np.asarray(vabc_np))
    r2_ints = _ints(np.asarray(r2_np))
    u_ints = _ints(np.asarray(u_np))
    claim_w = _ints(np.asarray(cw_np))

    t.challenge_vector(b"challenge_tau", mu_x)
    e = 0
    p1 = []
    for e0, e2, e3 in r1_ints:
        e1 = (e - e0) % MOD
        t.append_scalar(b"sc1/e0", nizk._sb(e0))
        t.append_scalar(b"sc1/e2", nizk._sb(e2))
        t.append_scalar(b"sc1/e3", nizk._sb(e3))
        r = t.challenge_scalar(b"sc1/r")
        p1.append([e0, e1, e2, e3])
        e = sumcheck.lagrange_eval([e0, e1, e2, e3], r)

    t.append_scalar(b"vA", nizk._sb(vA))
    t.append_scalar(b"vB", nizk._sb(vB))
    t.append_scalar(b"vC", nizk._sb(vC))
    r_a = t.challenge_scalar(b"challenge_Az")
    r_b = t.challenge_scalar(b"challenge_Bz")
    r_c = t.challenge_scalar(b"challenge_Cz")
    e = (r_a * vA + r_b * vB + r_c * vC) % MOD
    p2 = []
    ry = []
    for e0, e2 in r2_ints:
        e1 = (e - e0) % MOD
        t.append_scalar(b"sc2/e0", nizk._sb(e0))
        t.append_scalar(b"sc2/e2", nizk._sb(e2))
        r = t.challenge_scalar(b"sc2/r")
        p2.append([e0, e1, e2])
        ry.append(r)
        e = sumcheck.lagrange_eval([e0, e1, e2], r)

    t.append_scalar(b"claim_w", nizk._sb(claim_w))
    proof_bullet = nizk._prove_opening(t, mu_rows, mu_cols, ry[1:], u_ints)
    return nizk.NIZKProof(
        comm_vars=comm_enc,
        phase1_polys=p1,
        claims_abc=(vA, vB, vC),
        phase2_polys=p2,
        claim_w=claim_w,
        bullet=proof_bullet,
    )
