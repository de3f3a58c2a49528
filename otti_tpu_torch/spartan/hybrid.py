"""Device-transcript Spartan provers with the witness commitment absorbed on
the host (port of otti_tpu/spartan/hybrid.py): the JAX CLI's default at
padded sizes above 2^12.

The host commits to the witness, fetches the row encodings (transfer 1),
absorbs them and draws tau; the sponge state moves to the device
(``_check_handoff``: it must sit at the post-challenge offsets), and the
device runs the rest as one chain that the host enqueues without waiting on
the card: phase 1 (``_phase1``: every round, vA/vB/vC and the phase-2
challenges), the phase-2 table, phase 2 (``_phase2``), the opening materials
(``_opening``), and in zero knowledge every round commitment, the sigma
arithmetic and the inter-phase section (``_zk_mid``).  One packed fetch
brings the materials back (transfer 2, ``_fetch_packed``), and the host
replays or resumes the transcript to assemble the proof.  The JAX package
pays exactly these two transfers; so does the port, and with
``OTTI_SYNC_CHECK=1`` on a CUDA device torch raises if anything in the chain
waits on the card.

In the JAX package this module exists to cut compile time: phase kernels
keyed by padded size, and a zk phase split into segments of 8 rounds with a
physical shrink of the tables between them (``_zk_phase_segmented``,
``_shrink_kernel``).  Eager torch compiles nothing: a phase here is one loop
over tables that kernel 2 binds in place and only ever reads in their
active prefix, so it does the work of the segmented form without the
copies, and the bytes of the proof are the same.  fused.py and zkfused.py
run the same chain after absorbing the witness commitment on the device;
the JAX package's batched forms (``--batch``) are not ported here.

The provers run under ``torch.inference_mode()``: no tensor of a proof
needs autograd, and without its bookkeeping each of the chain's many small
torch ops costs the host a quarter to a third less.

Wire format: byte-identical to nizk.prove / zknizk.prove
(tests/test_torch_device_fs.py); verification uses the standard verifiers.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .. import metrics
from ..field import ops as F
from ..field.fields import SCALAR
from ..transcript.device import DeviceTranscript, export_host_strobe
from ..transcript.merlin import Transcript, transcript_from_strobe_state
from . import commitments, mle, nizk, r1cs
from .fused import _POST_CHALLENGE, _round_scan, assemble_plain_proof
from .nizk import GENS_LABEL, _hyrax_dims, _sb

MOD = SCALAR.modulus


@contextlib.contextmanager
def _no_host_sync(device):
    """With OTTI_SYNC_CHECK=1 on a CUDA device, torch raises on any
    operation in this stretch that waits on the card (a device->host copy,
    ``.item()``, ``nonzero``, a blocking host->device copy)."""
    if not (os.environ.get("OTTI_SYNC_CHECK") and torch.device(device).type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _stage(name: str, device):
    """With OTTI_SYNC_METRICS=1 a stage of the chain waits for the card at
    its end, so that its metric holds its device time (costs the overlap)."""
    if not os.environ.get("OTTI_SYNC_METRICS"):
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def timed():
        with metrics.timed(name):
            yield
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()

    return timed()


def _fetch_packed(int_arrs: list, u8_arrs: list):
    """Many device tensors in two transfers: the int32 ones concatenated
    into one flat buffer, the uint8 ones into another, split back on the
    host.  Returns (numpy arrays of int_arrs, numpy arrays of u8_arrs)."""
    def pull(arrs, dtype):
        if not arrs:
            return []
        flat = torch.cat([a.reshape(-1).to(dtype) for a in arrs]).cpu().numpy()
        outs, off = [], 0
        for a in arrs:
            n = a.numel()
            outs.append(flat[off : off + n].reshape(tuple(a.shape)))
            off += n
        return outs

    return pull(int_arrs, torch.int32), pull(u8_arrs, torch.uint8)


def _check_handoff(t: Transcript, device) -> DeviceTranscript:
    """The host transcript continued on ``device``; the phases resume the
    sponge at the post-challenge offsets, so it must be exactly there."""
    _, pos, pos_begin, flags = export_host_strobe(t.strobe)
    assert (pos, pos_begin, flags) == _POST_CHALLENGE, (
        "host transcript not at the post-challenge offsets")
    return DeviceTranscript.from_host(t, device)


def _fork(t: Transcript) -> Transcript:
    """Independent copy of a host transcript (pure-Python strobe)."""
    st, pos, pos_begin, flags = export_host_strobe(t.strobe)
    return transcript_from_strobe_state(st.tobytes(), pos, pos_begin, flags)


# ---------------------------------------------------------------------------
# Plain NIZK phases
# ---------------------------------------------------------------------------

def _phase1(t: DeviceTranscript, eq, az, bz, cz):
    """All rounds of the cubic phase, then vA/vB/vC absorbed and the
    phase-2 challenges.  Returns (rounds, rxs, vabc [3, 22], rabc [3, 22])."""
    rounds, rxs = _round_scan(t, [eq, az, bz, cz], 3, b"sc1")
    vabc = F.canon(SCALAR, torch.stack([az[0], bz[0], cz[0]]))
    for lbl, v in zip((b"vA", b"vB", b"vC"), vabc):
        t.append_scalar_limbs(lbl, v)
    rabc = torch.stack([t.challenge_scalar_limbs(lbl)
                        for lbl in (b"challenge_Az", b"challenge_Bz", b"challenge_Cz")])
    return rounds, rxs, vabc, rabc


def _phase2(t: DeviceTranscript, m_table, z):
    """All rounds of the quadratic phase (``z`` is bound in place)."""
    return _round_scan(t, [m_table, z], 2, b"sc2")


def _row_weights(r_w, mu_rows: int, device):
    if mu_rows:
        return mle.eq_table(r_w[:mu_rows])
    return F.ones(SCALAR, (1,), device)


def _opening(w_flat, rys, mu_rows: int, mu_cols: int):
    """Hyrax opening materials u = L^T W and claim_w = W(ry[1:])."""
    r_w = rys[1:]
    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    eq_L = _row_weights(r_w, mu_rows, w_flat.device)
    u = F.canon(SCALAR, F.sum_reduce(SCALAR, F.mul(SCALAR, eq_L[:, None, :], W), axis=0))
    claim_w = F.canon(SCALAR, F.dot(SCALAR, mle.eq_table(r_w), w_flat))
    return u, claim_w


def _device_chain(dev: r1cs.R1CSDevice, t: DeviceTranscript, tau, z, w_flat, mu_rows: int,
                  mu_cols: int) -> tuple:
    """From tau to the opening materials, on the device, with ``t`` at the
    post-challenge offsets.  Returns (rounds1, vabc, rounds2, u, claim_w)."""
    eq_tau = mle.eq_table(tau)
    az, bz, cz = dev.matvecs(z)
    rounds1, rxs, vabc, rabc = _phase1(t, eq_tau, az, bz, cz)
    m_table = dev.matvec_T_weighted((rabc[0], rabc[1], rabc[2]), mle.eq_table(rxs))
    rounds2, rys = _phase2(t, m_table, z)
    u, claim_w = _opening(w_flat, rys, mu_rows, mu_cols)
    return rounds1, vabc, rounds2, u, claim_w


@torch.inference_mode()
def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list, proto: bytes = None):
    """Drop-in replacement for nizk.prove producing byte-identical proofs,
    with two device->host transfers whatever the instance's size."""
    device = dev.device
    t = Transcript(proto or nizk.PROTO)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))

    nvp = dev.num_vars
    metrics.add("constraints", dev.num_cons)
    metrics.add("msm_points", nvp)
    mu_rows, mu_cols = _hyrax_dims(nvp)
    mu_x = (dev.num_cons - 1).bit_length()
    vars_padded = list(vars_ints) + [0] * (nvp - len(vars_ints))

    # ---- commitment (device MSM) + its encodings (host transfer 1) ----------
    w_flat = nizk._vec(vars_padded, device)
    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    with metrics.timed("commit"):
        comm_enc = commitments.encode_points(
            commitments.commit_rows(W, [0] * (1 << mu_rows), GENS_LABEL))
    # advance a scratch replica past the commitment to tau, leaving ``t``
    # pristine for assemble_plain_proof's replay
    t2 = _fork(t)
    for enc in comm_enc:
        t2.append_point(b"poly_commitment", enc)
    tau = t2.challenge_vector(b"challenge_tau", mu_x)

    # ---- the device chain (no host sync), then transfer 2 ------------------
    with metrics.timed("device_chain"):
        td = _check_handoff(t2, device)
        z = r1cs.assemble_z(w_flat, nizk._vec(inputs_ints, device) if inputs_ints else None, nvp)
        tau_dev = nizk._vec(tau, device)
        with _no_host_sync(device):
            rounds1, vabc, rounds2, u, claim_w = _device_chain(
                dev, td, tau_dev, z, w_flat, mu_rows, mu_cols)
        (r1_np, vabc_np, r2_np, u_np, cw_np), _ = _fetch_packed(
            [rounds1, vabc, rounds2, u, claim_w], [])
    metrics.add("sumcheck_rounds", mu_x)

    with metrics.timed("host_tail"):
        return assemble_plain_proof(
            t, comm_enc, r1_np, vabc_np, r2_np, u_np, cw_np, mu_x, mu_rows, mu_cols)


# ---------------------------------------------------------------------------
# Zero-knowledge phases (default CLI mode above the fused crossover)
# ---------------------------------------------------------------------------

def _zk_phase1(t: DeviceTranscript, tables: list, sc1_blinds: tuple, tbl_sc1: dict):
    """All rounds of the zk cubic phase.  Returns (e1, be1, encs, z, zdb,
    rxs, vabc)."""
    from .zkfused import _zk_round_scan

    zero = F.zeros((), tables[0].device)
    e1, be1, encs, zz, zdb, rxs = _zk_round_scan(t, b"sc1", 3, tbl_sc1, tables, sc1_blinds,
                                                 zero, zero)
    vabc = F.canon(SCALAR, torch.stack([tables[1][0], tables[2][0], tables[3][0]]))
    return e1, be1, encs, zz, zdb, rxs, vabc


def _zk_mid(t: DeviceTranscript, tau, rxs, vabc, abc_blinds, prod_blinds, eq1_a, e1, be1,
            tbl_mid: dict):
    """The inter-phase sigma section (zkfused._mid_zk).  Returns (mid_encs,
    mid_z, rabc, claim2, bclaim2)."""
    from .zkfused import _mid_zk

    return _mid_zk(t, tau, rxs, vabc[0], vabc[1], vabc[2], abc_blinds, prod_blinds, eq1_a,
                   e1, be1, tbl_mid)


def _zk_phase2(t: DeviceTranscript, m_table, z, claim2, bclaim2, sc2_blinds: tuple,
               tbl_sc2: dict):
    """All rounds of the zk quadratic phase (``z`` bound in place).  Returns
    (e2, be2, encs, z, zdb, rys), e2 and be2 canonical."""
    from .zkfused import _zk_round_scan

    e2, be2, encs, zz, zdb, rys = _zk_round_scan(t, b"sc2", 2, tbl_sc2, [m_table, z],
                                                 sc2_blinds, claim2, bclaim2)
    return F.canon(SCALAR, e2), F.canon(SCALAR, be2), encs, zz, zdb, rys


def _zk_opening(w_flat, row_blinds, rys, eabc, rabc, mu_rows: int, mu_cols: int):
    """u = L^T W, and [b_u = <L, row_blinds>, w_eval = W(ry[1:]),
    v_m = r_a ea + r_b eb + r_c ec] (matrix evaluations passed in)."""
    r_w = rys[1:]
    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    eq_L = _row_weights(r_w, mu_rows, w_flat.device)
    u = F.canon(SCALAR, F.sum_reduce(SCALAR, F.mul(SCALAR, eq_L[:, None, :], W), axis=0))
    b_u = F.canon(SCALAR, F.dot(SCALAR, eq_L, row_blinds))
    w_eval = F.canon(SCALAR, F.dot(SCALAR, mle.eq_table(r_w), w_flat))
    v_m = F.canon(SCALAR, F.sum_reduce(SCALAR, F.mul(SCALAR, rabc, eabc)))
    return u, torch.stack([b_u, w_eval, v_m])


def _zk_device_chain(dev: r1cs.R1CSDevice, t: DeviceTranscript, tau, z, w_flat, row_blinds,
                     sc1_blinds, abc, prod, eq1_a, sc2_blinds, tbls: tuple, mu_rows: int,
                     mu_cols: int) -> dict:
    """From tau to the opening materials in zero knowledge, on the device,
    with ``t`` at the post-challenge offsets.  ``tbls`` = comb tables (sc1
    rounds, mid section, sc2 rounds).  Returns the named materials."""
    tbl_sc1, tbl_mid, tbl_sc2 = tbls
    device = z.device
    eq_tau = mle.eq_table(tau)
    with _stage("matvecs", device):
        az, bz, cz = dev.matvecs(z)
    with _stage("zk_phase1", device):
        e1, be1, sc1_encs, sc1_z, sc1_zdb, rxs, vabc = _zk_phase1(
            t, [eq_tau, az, bz, cz], sc1_blinds, tbl_sc1)
    with _stage("zk_mid", device):
        mid_encs, mid_z, rabc, claim2, bclaim2 = _zk_mid(
            t, tau, rxs, vabc, abc, prod, eq1_a, e1, be1, tbl_mid)
    e_rx = mle.eq_table(rxs)
    with _stage("m_table", device):
        m_table = dev.matvec_T_weighted((rabc[0], rabc[1], rabc[2]), e_rx)
    with _stage("zk_phase2", device):
        e2, be2, sc2_encs, sc2_z, sc2_zdb, rys = _zk_phase2(
            t, m_table, z, claim2, bclaim2, sc2_blinds, tbl_sc2)
    with _stage("eval_at", device):
        eabc = torch.stack(dev.eval_at(e_rx, mle.eq_table(rys)))
    with _stage("opening", device):
        u, buwv = _zk_opening(w_flat, row_blinds, rys, eabc, rabc, mu_rows, mu_cols)
    return dict(state2=t.strobe.state, sc1_encs=sc1_encs, sc1_z=sc1_z, sc1_zdb=sc1_zdb,
                mid_encs=mid_encs, mid_z=mid_z, sc2_encs=sc2_encs, sc2_z=sc2_z,
                sc2_zdb=sc2_zdb, u=u, tail_vals=torch.cat([buwv, torch.stack([e2, be2])]),
                rys=rys)


_INT_KEYS = ("sc1_z", "sc1_zdb", "mid_z", "sc2_z", "sc2_zdb", "u", "tail_vals", "rys")
_U8_KEYS = ("state2", "sc1_encs", "mid_encs", "sc2_encs")


def _fetch_zk(out: dict, extra_u8: tuple = ()) -> dict:
    """The zk chain's materials (and ``extra_u8``, more uint8 tensors) in
    two packed transfers -> numpy arrays by name (the extras under "extra")."""
    ints, u8s = _fetch_packed([out[k] for k in _INT_KEYS],
                              [out[k] for k in _U8_KEYS] + list(extra_u8))
    got = dict(zip(_INT_KEYS, ints))
    got.update(zip(_U8_KEYS, u8s))
    got["extra"] = u8s[len(_U8_KEYS):]
    return got


def _zk_uploads(rng, dev: r1cs.R1CSDevice, mu_rows: int):
    """Every blind of the proof up to the host tail, drawn in zknizk.prove's
    order (``rng`` is left where the tail continues), and uploaded.
    Returns (row_blinds ints, row_blinds, sc1, abc, prod, eq1_a, sc2)."""
    from .zkfused import _devs

    device = dev.device
    mu_x = (dev.num_cons - 1).bit_length()
    mu_y = (dev.num_z - 1).bit_length()
    row_blinds = rng.scalars(1 << mu_rows)

    def sc_draws(n_rounds, degree):
        bp, bn, dd, rd, rb = [], [], [], [], []
        for _ in range(n_rounds):
            bp.append(rng.scalar())
            bn.append(rng.scalar())
            dd.extend(rng.scalars(degree + 1))
            rd.append(rng.scalar())
            rb.append(rng.scalar())
        return (_devs(bp, device), _devs(bn, device),
                _devs(dd, device).reshape(n_rounds, degree + 1, -1),
                _devs(rd, device), _devs(rb, device))

    sc1 = sc_draws(mu_x, 3)
    abc = rng.scalars(3) + [rng.scalar()]  # bA, bB, bC, b_ab
    prod = rng.scalars(5)
    eq1_a = rng.scalar()
    sc2 = sc_draws(mu_y, 2)
    # the opening's and eq2's blinds are drawn by the host tail
    return (row_blinds, _devs(row_blinds, device), sc1, _devs(abc, device),
            _devs(prod, device), _devs([eq1_a], device)[0], sc2)


@torch.inference_mode()
def prove_zk(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list,
             seed: bytes | None = None):
    """Drop-in replacement for zknizk.prove (same seed -> byte-identical
    proof), with two device->host transfers whatever the instance's size."""
    from .pedersen_host import BlindSource
    from .zkfused import _mid_tables, _round_tables, assemble_zk_proof
    from .zknizk import PROTO as ZK_PROTO

    device = dev.device
    rng = BlindSource(seed or os.urandom(32))
    nvp = dev.num_vars
    mu_rows, mu_cols = _hyrax_dims(nvp)
    mu_x = (dev.num_cons - 1).bit_length()
    row_ints, row_blinds, sc1, abc, prod, eq1_a, sc2 = _zk_uploads(rng, dev, mu_rows)

    t = Transcript(ZK_PROTO)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))

    metrics.add("constraints", dev.num_cons)
    metrics.add("msm_points", nvp)
    vars_padded = list(vars_ints) + [0] * (nvp - len(vars_ints))

    # ---- blinded commitment + encodings (host transfer 1) ------------------
    w_flat = nizk._vec(vars_padded, device)
    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    with metrics.timed("commit"):
        comm_enc = commitments.encode_points(commitments.commit_rows(W, row_ints, GENS_LABEL))
    for enc in comm_enc:
        t.append_point(b"poly_commitment", enc)
    tau = t.challenge_vector(b"challenge_tau", mu_x)

    # ---- the device chain (no host sync), then transfer 2 ------------------
    with metrics.timed("device_chain"):
        td = _check_handoff(t, device)
        z = r1cs.assemble_z(w_flat, nizk._vec(inputs_ints, device) if inputs_ints else None, nvp)
        tau_dev = nizk._vec(tau, device)
        tbls = (_round_tables(3, device), _mid_tables(device), _round_tables(2, device))
        with _no_host_sync(device):
            out = _zk_device_chain(dev, td, tau_dev, z, w_flat, row_blinds, sc1, abc, prod,
                                   eq1_a, sc2, tbls, mu_rows, mu_cols)
        with metrics.timed("fetch"):
            got = _fetch_zk(out)
    metrics.add("sumcheck_rounds", mu_x)

    with metrics.timed("host_tail"):
        return assemble_zk_proof(dev, rng, comm_enc, got)
