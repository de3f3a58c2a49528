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
run the same chain after absorbing the witness commitment on the device.
The JAX package's batched forms (``_phase1_batched``, ``_zk_seg_batched``,
... for ``--batch``) are this same chain: every phase, the transcript, the
sumcheck round and the round commitments take a leading batch axis, and
spartan/batched.py runs the chain once for B instances.  ``prove`` and
``prove_zk`` are its batch of one.

The provers run under ``torch.inference_mode()``: no tensor of a proof
needs autograd, and without its bookkeeping each of the chain's many small
torch ops costs the host a quarter to a third less.

Wire format: byte-identical to nizk.prove / zknizk.prove
(tests/test_torch_device_fs.py); verification uses the standard verifiers.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

from .. import metrics
from ..field import ops as F
from ..field.fields import N_LIMBS, SCALAR
from ..transcript.device import POST_CHALLENGE, DeviceStrobe, DeviceTranscript, export_host_strobe
from ..transcript.merlin import Transcript, transcript_from_strobe_state
from . import mle, r1cs
from .fused import _round_scan

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


_stages = threading.local()  # .pairs: the list _stage's event pairs go to, or None


@contextlib.contextmanager
def _stage(name: str, device):
    """A stage of the chain on a CUDA ``device``: a timing event recorded on
    the current stream at its start and at its end, kept as (name, start,
    end) in the innermost ``_collect``ed list.  Under a graph capture the
    events are external: two event-record nodes of the graph, recorded
    again by every replay.  Nothing waits on the card; outside a
    collection, and on the CPU, nothing is recorded."""
    pairs = getattr(_stages, "pairs", None)
    if pairs is None or torch.device(device).type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(device)
    external = torch.cuda.is_current_stream_capturing()
    start, end = (torch.cuda.Event(enable_timing=True, external=external) for _ in range(2))
    start.record(stream)
    yield
    end.record(stream)
    pairs.append((name, start, end))


@contextlib.contextmanager
def _collect():
    """The ``_stage`` event pairs recorded inside, as a list."""
    prev = getattr(_stages, "pairs", None)
    _stages.pairs = []
    try:
        yield _stages.pairs
    finally:
        _stages.pairs = prev


def _add_stage_times(pairs: list) -> None:
    """Each stage's device time as the counter ``<name>_dev_s`` (a stage
    met twice, as the exchange is, sums); call it once a fetch has
    synchronised the stream the pairs were recorded on."""
    for name, start, end in pairs:
        metrics.add(name + "_dev_s", start.elapsed_time(end) / 1e3)


@contextlib.contextmanager
def _stage_times():
    """The stages recorded inside, whose last act must be the fetch that
    synchronises their stream, added as ``<name>_dev_s`` at its end."""
    with _collect() as pairs:
        yield
    _add_stage_times(pairs)


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


def _check_handoff(ts: list, device) -> DeviceTranscript:
    """B host transcripts continued on ``device`` as one [B, 200] state
    (one as a [200] state); the phases resume every sponge at the
    post-challenge offsets, so each must be exactly there."""
    states = []
    for t in ts:
        st, pos, pos_begin, flags = export_host_strobe(t.strobe)
        assert (pos, pos_begin, flags) == POST_CHALLENGE, (
            "host transcript not at the post-challenge offsets")
        states.append(st)
    state = torch.from_numpy(np.stack(states) if len(states) > 1 else states[0]).to(device)
    return DeviceTranscript(_strobe=DeviceStrobe.from_state(state, *POST_CHALLENGE))


def _fork(t: Transcript) -> Transcript:
    """Independent copy of a host transcript (pure-Python strobe)."""
    st, pos, pos_begin, flags = export_host_strobe(t.strobe)
    return transcript_from_strobe_state(st.tobytes(), pos, pos_begin, flags)


# ---------------------------------------------------------------------------
# Plain NIZK phases
# ---------------------------------------------------------------------------

def _phase1(t: DeviceTranscript, eq, az, bz, cz):
    """All rounds of the cubic phase, then vA/vB/vC absorbed and the
    phase-2 challenges.  Returns (rounds, rxs, vabc [3, 22], rabc [3, 22]);
    every phase here takes a leading batch axis ([B, n, 22] tables, a
    transcript of B states) and gives every result one."""
    rounds, rxs = _round_scan(t, [eq, az, bz, cz], 3, b"sc1")
    vabc = F.canon(SCALAR, torch.stack([az[..., 0, :], bz[..., 0, :], cz[..., 0, :]], dim=-2))
    for lbl, v in zip((b"vA", b"vB", b"vC"), vabc.unbind(-2)):
        t.append_scalar_limbs(lbl, v)
    rabc = torch.stack([t.challenge_scalar_limbs(lbl)
                        for lbl in (b"challenge_Az", b"challenge_Bz", b"challenge_Cz")], dim=-2)
    return rounds, rxs, vabc, rabc


def _phase2(t: DeviceTranscript, m_table, z):
    """All rounds of the quadratic phase (``z`` is bound in place)."""
    return _round_scan(t, [m_table, z], 2, b"sc2")


def _row_weights(r_w, mu_rows: int):
    """eq(r_w[:mu_rows], .) over the Hyrax rows: [..., rows, 22]."""
    if mu_rows:
        return mle.eq_table(r_w[..., :mu_rows, :])
    return F.ones(SCALAR, tuple(r_w.shape[:-2]) + (1,), r_w.device)


def _opening_common(w_flat, rys, mu_rows: int, mu_cols: int):
    """(eq_L [.., rows, 22], u = L^T W [.., cols, 22], W(ry[1:]) [.., 22])."""
    r_w = rys[..., 1:, :]
    W = w_flat.reshape(tuple(w_flat.shape[:-2]) + (1 << mu_rows, 1 << mu_cols, -1))
    eq_L = _row_weights(r_w, mu_rows)
    u = F.canon(SCALAR, F.sum_reduce(SCALAR, F.mul(SCALAR, eq_L[..., None, :], W), axis=-3))
    w_eval = F.canon(SCALAR, F.dot(SCALAR, mle.eq_table(r_w), w_flat, axis=-2))
    return eq_L, u, w_eval


def _opening(w_flat, rys, mu_rows: int, mu_cols: int):
    """Hyrax opening materials u = L^T W and claim_w = W(ry[1:])."""
    _, u, claim_w = _opening_common(w_flat, rys, mu_rows, mu_cols)
    return u, claim_w


def _device_chain(dev: r1cs.R1CSDevice, t: DeviceTranscript, tau, z, w_flat, mu_rows: int,
                  mu_cols: int) -> tuple:
    """From tau to the opening materials, on the device, with ``t`` at the
    post-challenge offsets.  Returns (rounds1, vabc, rounds2, u, claim_w)."""
    eq_tau = mle.eq_table(tau)
    az, bz, cz = dev.matvecs(z)
    rounds1, rxs, vabc, rabc = _phase1(t, eq_tau, az, bz, cz)
    m_table = dev.matvec_T_weighted(rabc.unbind(-2), mle.eq_table(rxs))
    rounds2, rys = _phase2(t, m_table, z)
    u, claim_w = _opening(w_flat, rys, mu_rows, mu_cols)
    return rounds1, vabc, rounds2, u, claim_w


def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list, proto: bytes = None):
    """Drop-in replacement for nizk.prove producing byte-identical proofs,
    with two device->host transfers whatever the instance's size: a batch
    of one (batched.prove_many)."""
    from .batched import prove_many

    return prove_many([dev], [vars_ints], [inputs_ints], proto=proto)[0]


# ---------------------------------------------------------------------------
# Zero-knowledge phases (default CLI mode above the fused crossover)
# ---------------------------------------------------------------------------

def _zk_phase1(t: DeviceTranscript, tables: list, sc1_blinds: tuple, tbl_sc1: dict):
    """All rounds of the zk cubic phase.  Returns (e1, be1, encs, z, zdb,
    rxs, vabc)."""
    from .zkfused import _zk_round_scan

    zero = F.zeros(tuple(tables[0].shape[:-2]), tables[0].device)
    e1, be1, encs, zz, zdb, rxs = _zk_round_scan(t, b"sc1", 3, tbl_sc1, tables, sc1_blinds,
                                                 zero, zero)
    vabc = F.canon(SCALAR, torch.stack([tb[..., 0, :] for tb in tables[1:]], dim=-2))
    return e1, be1, encs, zz, zdb, rxs, vabc


def _zk_mid(t: DeviceTranscript, tau, rxs, vabc, abc_blinds, prod_blinds, eq1_a, e1, be1,
            tbl_mid: dict):
    """The inter-phase sigma section (zkfused._mid_zk).  Returns (mid_encs,
    mid_z, rabc, claim2, bclaim2)."""
    from .zkfused import _mid_zk

    return _mid_zk(t, tau, rxs, *vabc.unbind(-2), abc_blinds, prod_blinds, eq1_a,
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
    eq_L, u, w_eval = _opening_common(w_flat, rys, mu_rows, mu_cols)
    b_u = F.canon(SCALAR, F.dot(SCALAR, eq_L, row_blinds, axis=-2))
    v_m = F.canon(SCALAR, F.sum_reduce(SCALAR, F.mul(SCALAR, rabc, eabc), axis=-2))
    return u, torch.stack([b_u, w_eval, v_m], dim=-2)


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
        m_table = dev.matvec_T_weighted(rabc.unbind(-2), e_rx)
    with _stage("zk_phase2", device):
        e2, be2, sc2_encs, sc2_z, sc2_zdb, rys = _zk_phase2(
            t, m_table, z, claim2, bclaim2, sc2_blinds, tbl_sc2)
    with _stage("eval_at", device):
        eabc = torch.stack(dev.eval_at(e_rx, mle.eq_table(rys)), dim=-2)
    with _stage("opening", device):
        u, buwv = _zk_opening(w_flat, row_blinds, rys, eabc, rabc, mu_rows, mu_cols)
    return dict(state2=t.strobe.state, sc1_encs=sc1_encs, sc1_z=sc1_z, sc1_zdb=sc1_zdb,
                mid_encs=mid_encs, mid_z=mid_z, sc2_encs=sc2_encs, sc2_z=sc2_z,
                sc2_zdb=sc2_zdb, u=u, tail_vals=torch.cat([buwv, torch.stack([e2, be2], dim=-2)],
                                                          dim=-2),
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


def _zk_uploads(rngs: list, dev, mu_rows: int):
    """Every blind of the proof up to the host tail, drawn from each
    instance's ``rng`` in zknizk.prove's order (each ``rng`` is left where
    its tail continues), and uploaded with a leading axis of len(rngs), one
    upload a kind.  Returns (row blinds as ints an instance, row_blinds,
    sc1, abc, prod, eq1_a, sc2)."""
    from .zkfused import _devs

    device = dev.device
    mu_x = (dev.num_cons - 1).bit_length()
    mu_y = (dev.num_z - 1).bit_length()
    nb = len(rngs)
    draws = []
    for rng in rngs:
        d = {"rows": rng.scalars(1 << mu_rows)}

        def sc_draws(n_rounds, degree):
            bp, bn, dd, rd, rb = [], [], [], [], []
            for _ in range(n_rounds):
                bp.append(rng.scalar())
                bn.append(rng.scalar())
                dd.extend(rng.scalars(degree + 1))
                rd.append(rng.scalar())
                rb.append(rng.scalar())
            return bp, bn, dd, rd, rb

        d["sc1"] = sc_draws(mu_x, 3)
        d["abc"] = rng.scalars(3) + [rng.scalar()]  # bA, bB, bC, b_ab
        d["prod"] = rng.scalars(5)
        d["eq1_a"] = [rng.scalar()]
        d["sc2"] = sc_draws(mu_y, 2)
        # the opening's and eq2's blinds are drawn by the host tail
        draws.append(d)

    def up(get, *shape):
        return _devs([x for d in draws for x in get(d)], device).reshape((nb,) + shape + (N_LIMBS,))

    def sc(key, n_rounds, degree):
        return tuple(up(lambda d, i=i: d[key][i], n_rounds, *((degree + 1,) if i == 2 else ()))
                     for i in range(5))

    return ([d["rows"] for d in draws], up(lambda d: d["rows"], 1 << mu_rows),
            sc("sc1", mu_x, 3), up(lambda d: d["abc"], 4), up(lambda d: d["prod"], 5),
            up(lambda d: d["eq1_a"]), sc("sc2", mu_y, 2))


def _first(uploads: tuple) -> tuple:
    """_zk_uploads of one instance without its batch axis (views)."""
    row_ints, *rest = uploads
    return (row_ints[0],) + tuple(
        tuple(x[0] for x in u) if isinstance(u, tuple) else u[0] for u in rest)


def prove_zk(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list,
             seed: bytes | None = None):
    """Drop-in replacement for zknizk.prove (same seed -> byte-identical
    proof), with two device->host transfers whatever the instance's size:
    a batch of one (batched.prove_many_zk)."""
    from .batched import prove_many_zk

    return prove_many_zk([dev], [vars_ints], [inputs_ints],
                         seeds=[seed] if seed else None)[0]
