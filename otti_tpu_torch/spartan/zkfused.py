"""Device-transcript zero-knowledge Spartan prover, one fetch a proof (port
of otti_tpu/spartan/zkfused.py): the JAX CLI's default up to padded size
2^12.

zknizk.prove fetches each zk sumcheck round's evaluations and does the
round's Pedersen commitments and its dot-product sigma proof on the host.
Here all of the argument up to the host tail runs on the device: the
blinded Hyrax rows and their encodings, both zk sumchecks with their five
commitments a round (fixed-base comb MSMs, msm/pippenger.py) and their
encodings (kernel K4), the sigma arithmetic, the product and equality proofs
of the inter-phase section, and the transcript (kernel K3).  The host draws
the blinds first, in zknizk.prove's order, and after one fetch runs the
log-sized blinded opening and the final equality proof, resuming the
transcript from the device's sponge state (``assemble_zk_proof``).

A round's five commitments are computed in three batched MSMs grouped by
what the transcript has fixed ({C_poly, delta} before r; {C_eval} after r;
{C_y, beta} after w0 and w1), and encoded in three batched calls; the
absorb order, and so the wire, is zknizk's.  On a CUDA device all of a
round after its evaluations is one launch of kernel K6
(zk_round_kernel.py), the same values and bytes.  The one variable-base term,
CA * b3 of the product proof, is ``edwards.scalar_mul``.

With the same blind seed the proof is byte-identical to zknizk.prove's
(tests/test_torch_device_fs.py) and verifies with zknizk.verify.  The
phases are hybrid.py's; this module holds the round, the inter-phase
section, the on-device witness commitment and the proof assembly.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import metrics
from ..curve import edwards as E
from ..curve import ristretto
from ..field import ops as F
from ..field.fields import N_LIMBS, SCALAR, ints_to_limbs, limbs_to_int
from ..msm import pippenger
from ..transcript.device import POST_CHALLENGE, DeviceTranscript
from ..transcript.merlin import Transcript
from . import r1cs, zk_round_kernel
from .nizk import GENS_LABEL, _hyrax_dims, _sb
from .sigma import DotProductProof, EqualityProof, ProductProof
from .sumcheck_kernels import sumcheck_round
from .zknizk import PROTO, ZKNIZKProof
from .zksumcheck import ZKSumcheckProof

MOD = SCALAR.modulus


def _devs(xs, device) -> torch.Tensor:
    return F.from_ints(SCALAR, [x % MOD for x in xs], device)


def _commit_rows_blinded(W: torch.Tensor, row_blinds: torch.Tensor, tbl: dict) -> dict:
    """Blinded Hyrax row commitments: [rows, cols, 22] scalars and [rows, 22]
    blinds on the device -> [rows] points, sum_c W[r, c] G_c + b_r H."""
    mat = torch.cat([W, row_blinds[:, None, :]], dim=1)
    return pippenger.msm_fixed_base(W.shape[1], GENS_LABEL, mat, with_blind=True, tbl=tbl)


@functools.lru_cache(maxsize=None)
def _vandermonde_inv(degree: int) -> tuple:
    """M with coeffs = M @ evals for p(i) = evals[i], i = 0..degree: the
    exact inverse of the Vandermonde matrix mod l, as rows of ints."""
    d = degree
    V = [[pow(i, j, MOD) for j in range(d + 1)] for i in range(d + 1)]
    inv = [[1 if i == j else 0 for j in range(d + 1)] for i in range(d + 1)]
    for col in range(d + 1):  # Gauss-Jordan over the field
        piv = next(r for r in range(col, d + 1) if V[r][col] % MOD)
        V[col], V[piv] = V[piv], V[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        inv_p = pow(V[col][col], MOD - 2, MOD)
        V[col] = [v * inv_p % MOD for v in V[col]]
        inv[col] = [v * inv_p % MOD for v in inv[col]]
        for r in range(d + 1):
            if r != col and V[r][col]:
                f = V[r][col]
                V[r] = [(v - f * w) % MOD for v, w in zip(V[r], V[col])]
                inv[r] = [(v - f * w) % MOD for v, w in zip(inv[r], inv[col])]
    return tuple(tuple(row) for row in inv)


_VANDERMONDE: dict = {}


def _vandermonde_inv_limbs(degree: int, device) -> torch.Tensor:
    """The matrix of ``_vandermonde_inv`` as limbs [d+1, d+1, 22] on
    ``device`` (uploaded once)."""
    key = (degree, str(device))
    m = _VANDERMONDE.get(key)
    if m is None:
        rows = _vandermonde_inv(degree)
        flat = np.asarray(ints_to_limbs([v for row in rows for v in row]), np.int32)
        m = _VANDERMONDE[key] = torch.from_numpy(
            flat.reshape(degree + 1, degree + 1, -1)).to(device)
    return m


def _round_tables(degree: int, device) -> dict:
    """Comb tables of the round commitment generators G_0..G_degree and H."""
    return pippenger.fixed_base_tables(degree + 1, GENS_LABEL, True, device)


def _mid_tables(device) -> dict:
    """Comb tables of (G_0, H), the inter-phase section's generators."""
    return pippenger.fixed_base_tables(1, GENS_LABEL, True, device)


def _commit_batch(tbl: dict, n_gens: int, rows: list) -> dict:
    """Rows of n_gens + 1 scalars (the blind last), each [22] or [B, 22] ->
    points [len(rows)] ([B, len(rows)]) over G_0..G_{n_gens-1}, H: one comb
    MSM for all B instances' rows."""
    mat = torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)
    pts = pippenger.msm_fixed_base(n_gens, GENS_LABEL, mat.reshape(-1, n_gens + 1, N_LIMBS),
                                   with_blind=True, tbl=tbl)
    return E.tree_map(lambda a: a.reshape(tuple(mat.shape[:-2]) + (N_LIMBS,)), pts)


def _zk_round_from_evals(label: bytes, degree: int, tbl: dict, t: DeviceTranscript, e, be,
                         evs, xs):
    """One zk round's commitments, transcript and sigma arithmetic, given the
    round's evaluations ``evs`` = [p(0), p(2)(, p(3))] (p(1) follows from the
    running claim ``e``); the tables are the caller's.  ``xs`` = (b_poly,
    b_next, d [degree+1, 22], r_delta, r_beta).  Advances ``t``; returns
    (e_next, b_next, r, encs [4, 32], z [degree+1, 22], zdb [2, 22]).  With
    a transcript of B states every argument and result has a leading axis B.
    On a CUDA device the round is one launch of kernel K6
    (zk_round_kernel.py); on the CPU it is ``_zk_round_plain``."""
    if t.device.type == "cuda":
        return zk_round_kernel.zk_round_cuda(label, degree, tbl["p"],
                                             _vandermonde_inv_limbs(degree, t.device), t, e, be,
                                             evs, xs)
    return _zk_round_plain(label, degree, tbl, t, e, be, evs, xs)


def _zk_round_plain(label: bytes, degree: int, tbl: dict, t: DeviceTranscript, e, be, evs, xs):
    """The round in torch ops, on any device: each commitment kind is one MSM
    and one encoding for the batch."""
    b_poly, b_next, d_vec, r_delta, r_beta = xs
    dev = e.device
    zero = F.zeros(tuple(e.shape[:-1]), dev)
    ev = torch.cat([evs[..., :1, :], F.canon(SCALAR, F.sub(SCALAR, e, evs[..., 0, :]))[..., None, :],
                    evs[..., 1:, :]], dim=-2)
    coeffs = F.sum_reduce(SCALAR, F.mul(SCALAR, _vandermonde_inv_limbs(degree, dev),
                                        ev[..., None, :, :]), axis=-2)  # [degree+1, 22]
    pad = [zero] * degree

    def commit_batch(rows):
        """rows of degree + 2 scalars (the blind last) -> points over G_0..G_degree, H."""
        return _commit_batch(tbl, degree + 1, rows)

    assert t.strobe.offsets == POST_CHALLENGE, "round not at the post-challenge offsets"
    # group 1 (independent of every challenge): C_poly and delta
    enc_g1 = ristretto.encode(commit_batch(
        [list(coeffs.unbind(-2)) + [b_poly], list(d_vec.unbind(-2)) + [r_delta]]))
    enc_poly, enc_delta = enc_g1[..., 0, :], enc_g1[..., 1, :]
    t.append_message(label + b"/comm_poly", enc_poly)
    r = t.challenge_scalar_limbs(label + b"/r")

    e_next = coeffs[..., -1, :]  # Horner
    for k in range(degree - 1, -1, -1):
        e_next = F.add(SCALAR, coeffs[..., k, :], F.mul(SCALAR, r, e_next))
    enc_next = ristretto.encode(commit_batch([[e_next] + pad + [b_next]]))[..., 0, :]
    t.append_message(label + b"/comm_eval", enc_next)
    w0 = t.challenge_scalar_limbs(label + b"/w0")
    w1 = t.challenge_scalar_limbs(label + b"/w1")

    # weight vector a = w0 (2, 1, .., 1) + w1 (1, r, r^2, ...)
    a = []
    r_pow = F.ones(SCALAR, tuple(e.shape[:-1]), dev)
    for k in range(degree + 1):
        base = F.add(SCALAR, w0, w0) if k == 0 else w0
        a.append(F.canon(SCALAR, F.add(SCALAR, base, F.mul(SCALAR, w1, r_pow))))
        if k < degree:
            r_pow = F.mul(SCALAR, r_pow, r)
    a = torch.stack(a, dim=-2)

    # DotProductProof: ties the committed coefficients to the committed claims
    t.append_message(b"protocol-name", b"dot product proof")
    t.append_message(b"Cx", enc_poly)
    y = F.add(SCALAR, F.mul(SCALAR, w0, e), F.mul(SCALAR, w1, e_next))
    ry_b = F.add(SCALAR, F.mul(SCALAR, w0, be), F.mul(SCALAR, w1, b_next))
    dy = F.dot(SCALAR, d_vec, a, axis=-2)
    # group 3 (needs w0, w1): C_y and beta
    enc_g3 = ristretto.encode(commit_batch([[y] + pad + [ry_b], [dy] + pad + [r_beta]]))
    t.append_message(b"Cy", enc_g3[..., 0, :])
    enc_beta = enc_g3[..., 1, :]
    for ak in a.unbind(-2):
        t.append_scalar_limbs(b"a", ak)
    t.append_message(b"delta", enc_delta)
    t.append_message(b"beta", enc_beta)
    c = t.challenge_scalar_limbs(b"c")[..., None, :]  # [1, 22]: a shared operand

    z = F.canon(SCALAR, F.add(SCALAR, F.mul(SCALAR, c, coeffs), d_vec))
    zdb = F.canon(SCALAR, F.add(SCALAR, F.mul(SCALAR, c, torch.stack([b_poly, ry_b], dim=-2)),
                                torch.stack([r_delta, r_beta], dim=-2)))
    encs = torch.stack([enc_poly, enc_next, enc_delta, enc_beta], dim=-2)
    return e_next, b_next, r, encs, z, zdb


def _zk_round_scan(t: DeviceTranscript, label: bytes, degree: int, tbl: dict, tables: list,
                   blinds: tuple, e, be):
    """All rounds of one zk sumcheck phase: kernel 2 evaluates (and binds the
    previous challenge, read from device memory), ``_zk_round_from_evals``
    does the rest.  ``blinds`` = per-round (b_poly, b_next, d, r_delta,
    r_beta) stacked over the rounds.  Mirrors zksumcheck.prove_zk and
    sigma.DotProductProof.prove message for message.  Returns (e, be, encs
    [mu, 4, 32], z [mu, degree+1, 22], zdb [mu, 2, 22], rs [mu, 22]); with
    [B, n, 22] tables the blinds and results have a leading axis B."""
    lead = tuple(tables[0].shape[:-2])
    ax = len(lead)  # the rounds' axis
    n = tables[0].shape[-2]
    mu = (n - 1).bit_length()
    dev = tables[0].device
    if mu == 0:
        return (e, be, torch.zeros(lead + (0, 4, 32), dtype=torch.uint8, device=dev),
                F.zeros(lead + (0, degree + 1), dev), F.zeros(lead + (0, 2), dev),
                F.zeros(lead + (0,), dev))
    evs = sumcheck_round(tables, degree)
    encs, zs, zdbs, rs = [], [], [], []
    active = n
    for j in range(mu):
        e, be, r, enc, z, zdb = _zk_round_from_evals(
            label, degree, tbl, t, e, be, evs, tuple(b.select(ax, j) for b in blinds))
        encs.append(enc)
        zs.append(z)
        zdbs.append(zdb)
        rs.append(r)
        evs = sumcheck_round(tables, degree, r, active // 2)
        active //= 2
    return (e, be, torch.stack(encs, dim=ax), torch.stack(zs, dim=ax),
            torch.stack(zdbs, dim=ax), torch.stack(rs, dim=ax))


def _prod_eq(vals: torch.Tensor) -> torch.Tensor:
    """prod_i vals[..., i, :] over a [..., mu, 22] array -> [..., 22]."""
    acc = vals[..., 0, :]
    for i in range(1, vals.shape[-2]):
        acc = F.mul(SCALAR, acc, vals[..., i, :])
    return acc


def _mid_zk(t: DeviceTranscript, tau, rxs, vA, vB, vC, abc_blinds, prod_blinds, eq1_a, e1, be1,
            tbl_mid: dict):
    """The inter-phase zk section: claim commitments CA/CB/CC, the product
    sigma proof for vA * vB, the phase-1 equality proof, and the phase-2
    challenges.  Advances ``t``; returns (mid_encs [8, 32], mid_z [6, 22],
    rabc [3, 22], claim2, bclaim2), each with a leading axis B for a
    transcript of B states."""
    dev = vA.device
    lead = tuple(vA.shape[:-1])
    one = F.ones(SCALAR, (), dev)
    zero = F.zeros(lead, dev)
    bA, bB, bC, b_ab = abc_blinds.unbind(-2)
    b1, b2, b3, b4, b5 = prod_blinds.unbind(-2)
    v_ab = F.mul(SCALAR, vA, vB)
    eq_terms = F.add(SCALAR, F.mul(SCALAR, tau, rxs),
                     F.mul(SCALAR, F.sub(SCALAR, one, tau), F.sub(SCALAR, one, rxs)))
    eq_val = _prod_eq(eq_terms)
    r2_eq1 = F.mul(SCALAR, eq_val, F.sub(SCALAR, b_ab, bC))

    # every commitment here is independent of the challenges: one batched
    # fixed-base MSM and one batched encode, plus the one variable-base term
    # CA * b3 of the product proof; the absorb order below is zknizk's
    rows = [
        [vA, bA], [vB, bB], [vC, bC], [v_ab, b_ab],
        [b1, b2], [b3, b4], [zero, b5],
        [e1, be1], [e1, r2_eq1], [zero, eq1_a],
    ]
    batch = _commit_batch(tbl_mid, 1, rows)
    CA = E.tree_map(lambda a: a[..., 0, :], batch)
    delta_p = E.add(E.scalar_mul(CA, b3), E.tree_map(lambda a: a[..., 6, :], batch))
    all_pts = E.tree_map(lambda b, d: torch.cat([b, d[..., None, :]], dim=-2), batch, delta_p)
    encs = ristretto.encode(all_pts)  # [11, 32]
    (enc_CA, enc_CB, enc_CC, enc_Cab, enc_alpha_p, enc_beta_p, _,
     enc_C1, enc_C2, enc_alpha_eq1, enc_delta_p) = encs.unbind(-2)

    t.append_message(b"CA", enc_CA)
    t.append_message(b"CB", enc_CB)
    t.append_message(b"CC", enc_CC)

    # ProductProof(vA, bA, vB, bB, b_ab)  [sigma.py order]
    t.append_message(b"protocol-name", b"product proof")
    t.append_message(b"Cx", enc_CA)
    t.append_message(b"Cy", enc_CB)
    t.append_message(b"Cz", enc_Cab)
    t.append_message(b"alpha", enc_alpha_p)
    t.append_message(b"beta", enc_beta_p)
    t.append_message(b"delta", enc_delta_p)
    c = t.challenge_scalar_limbs(b"c")
    z1234 = F.add(SCALAR, torch.stack([b1, b2, b3, b4], dim=-2),
                  F.mul(SCALAR, c[..., None, :], torch.stack([vA, bA, vB, bB], dim=-2)))
    z5 = F.add(SCALAR, b5, F.mul(SCALAR, c, F.sub(SCALAR, b_ab, F.mul(SCALAR, bA, vB))))

    # EqualityProof: e1 vs eq(tau, rx) * (vAB - vC)
    t.append_message(b"protocol-name", b"equality proof")
    t.append_message(b"C1", enc_C1)
    t.append_message(b"C2", enc_C2)
    t.append_message(b"alpha", enc_alpha_eq1)
    c = t.challenge_scalar_limbs(b"c")
    z_eq1 = F.add(SCALAR, F.mul(SCALAR, c, F.sub(SCALAR, be1, r2_eq1)), eq1_a)

    # ---- phase-2 challenges + committed claim2 ----------------------------
    rabc = torch.stack([t.challenge_scalar_limbs(lbl)
                        for lbl in (b"challenge_Az", b"challenge_Bz", b"challenge_Cz")], dim=-2)
    claim2 = F.sum_reduce(SCALAR, F.mul(SCALAR, rabc, torch.stack([vA, vB, vC], dim=-2)),
                          axis=-2)
    bclaim2 = F.sum_reduce(SCALAR, F.mul(SCALAR, rabc, torch.stack([bA, bB, bC], dim=-2)),
                           axis=-2)
    mid_encs = torch.stack([enc_CA, enc_CB, enc_CC, enc_Cab, enc_alpha_p, enc_beta_p,
                            enc_delta_p, enc_alpha_eq1], dim=-2)
    mid_z = F.canon(SCALAR, torch.cat([z1234, z5[..., None, :], z_eq1[..., None, :]], dim=-2))
    return mid_encs, mid_z, rabc, claim2, bclaim2


def _core(dev: r1cs.R1CSDevice, t: DeviceTranscript, w_flat, z, row_blinds, sc1, abc, prod,
          eq1_a, sc2, tbls: tuple, mu_rows: int, mu_cols: int) -> tuple:
    """The zk prover after the instance absorbs, all on the device: the
    blinded witness rows committed, encoded and absorbed, tau squeezed, then
    hybrid.py's zk chain.  ``tbls`` = comb tables (witness rows, sc1 rounds,
    mid section, sc2 rounds).  Returns (enc_rows [rows, 32], materials)."""
    from .hybrid import _zk_device_chain

    W = w_flat.reshape(1 << mu_rows, 1 << mu_cols, -1)
    enc_rows = ristretto.encode(_commit_rows_blinded(W, row_blinds, tbls[0]))
    for i in range(1 << mu_rows):
        t.append_message(b"poly_commitment", enc_rows[i])
    tau = t.challenge_vector_limbs(b"challenge_tau", (dev.num_cons - 1).bit_length())
    return enc_rows, _zk_device_chain(dev, t, tau, z, w_flat, row_blinds, sc1, abc, prod,
                                      eq1_a, sc2, tbls[1:], mu_rows, mu_cols)


def _int(row: np.ndarray) -> int:
    return limbs_to_int(row) % MOD


@torch.inference_mode()
def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list,
          seed: bytes | None = None) -> ZKNIZKProof:
    """Drop-in replacement for zknizk.prove: same seed -> byte-identical
    proof, verified by zknizk.verify; one fetch from the device."""
    from .hybrid import _fetch_zk, _first, _no_host_sync, _stage_times, _zk_uploads
    from .pedersen_host import BlindSource

    device = dev.device
    rng = BlindSource(seed or os.urandom(32))
    nvp = dev.num_vars
    mu_rows, mu_cols = _hyrax_dims(nvp)
    _, row_blinds, sc1, abc, prod, eq1_a, sc2 = _first(_zk_uploads([rng], dev, mu_rows))

    t = Transcript(PROTO)
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))

    metrics.add("constraints", dev.num_cons)
    metrics.add("msm_points", nvp)
    vars_padded = list(vars_ints) + [0] * (nvp - len(vars_ints))

    w_flat = _devs(vars_padded, device)
    z = r1cs.assemble_z(w_flat, _devs(inputs_ints, device) if inputs_ints else None, nvp)
    tbls = (pippenger.fixed_base_tables(1 << mu_cols, GENS_LABEL, True, device),
            _round_tables(3, device), _mid_tables(device), _round_tables(2, device))
    td = DeviceTranscript.from_host(t, device)
    with metrics.timed("zkfused_prove"), _stage_times():
        with _no_host_sync(device):
            enc_rows, out = _core(dev, td, w_flat, z, row_blinds, sc1, abc, prod, eq1_a, sc2,
                                  tbls, mu_rows, mu_cols)
        got = _fetch_zk(out, (enc_rows,))
    metrics.add("sumcheck_rounds", (dev.num_cons - 1).bit_length())
    comm_enc = [bytes(row.tobytes()) for row in got["extra"][0]]
    return assemble_zk_proof(dev, rng, comm_enc, got)


def assemble_zk_proof(dev: r1cs.R1CSDevice, rng, comm_enc: list, got: dict) -> ZKNIZKProof:
    """Package the fetched zk round materials into a ZKNIZKProof and run the
    host tail (blinded bullet opening + eq2), resuming the transcript from
    the device's sponge state.  Shared by the fused and hybrid provers;
    ``rng`` must be positioned just after the sc2 blind draws (zknizk.prove's
    order).  ``got``: numpy arrays by name (hybrid._fetch_zk); tail_vals =
    [b_u, w_eval, v_m, e2, be2] canonical limb rows."""
    from .nizk import _eq_weights
    from .pedersen_host import Gens
    from .zknizk import _max_gens, _opening_and_final_zk

    nvp = dev.num_vars
    mu_rows, mu_cols = _hyrax_dims(nvp)
    mu_x = (dev.num_cons - 1).bit_length()
    mu_y = (dev.num_z - 1).bit_length()
    cols = 1 << mu_cols

    def enc(a) -> bytes:
        return bytes(np.asarray(a).tobytes())

    def sc_proof(encs, zz, zdb, n_rounds, degree) -> ZKSumcheckProof:
        comm_polys = [enc(encs[j, 0]) for j in range(n_rounds)]
        comm_evals = [enc(encs[j, 1]) for j in range(n_rounds)]
        dots = [
            DotProductProof(
                delta=enc(encs[j, 2]),
                beta=enc(encs[j, 3]),
                z=[_int(zz[j, k]) for k in range(degree + 1)],
                z_delta=_int(zdb[j, 0]),
                z_beta=_int(zdb[j, 1]),
            )
            for j in range(n_rounds)
        ]
        return ZKSumcheckProof(comm_polys, comm_evals, dots)

    # ---- host tail: log-sized blinded opening + eq2, resuming the
    # transcript from the device sponge state; the SAME tail as zknizk.prove
    # (same rng position -> byte-identical proofs)
    from ..transcript.merlin import transcript_from_strobe_state

    t_tail = transcript_from_strobe_state(got["state2"].tobytes(), *POST_CHALLENGE)
    gens = Gens(_max_gens(dev), GENS_LABEL)
    with metrics.timed("host_decode"):
        u_limb, tail_vals, rys_limb = got["u"], got["tail_vals"], got["rys"]
        u_ints = [_int(u_limb[k]) for k in range(cols)]
        b_u, w_eval, v_m, e2, be2 = (_int(tail_vals[k]) for k in range(5))
        rys = [_int(rys_limb[k]) for k in range(mu_y)]
    r_w = rys[1:]
    with metrics.timed("host_sigma"):
        enc_w, enc_wq, base_eq, proof_bullet, eq2_proof = _opening_and_final_zk(
            t_tail, gens, mu_cols, u_ints, b_u, w_eval,
            _eq_weights(r_w[mu_rows:]), v_m, rys[0], e2, be2, rng,
        )
    with metrics.timed("host_serialize"):
        proof = _build_zk_proof_obj(
            comm_enc, sc_proof, enc, got["mid_encs"], got["mid_z"],
            got["sc1_encs"], got["sc1_z"], got["sc1_zdb"],
            got["sc2_encs"], got["sc2_z"], got["sc2_zdb"],
            mu_x, mu_y, enc_w, enc_wq, base_eq, proof_bullet, eq2_proof,
        )
    return proof


def _build_zk_proof_obj(comm_enc, sc_proof, enc, mid_encs, mid_z, sc1_encs, sc1_z, sc1_zdb,
                        sc2_encs, sc2_z, sc2_zdb, mu_x, mu_y, enc_w, enc_wq, base_eq,
                        proof_bullet, eq2_proof) -> ZKNIZKProof:
    return ZKNIZKProof(
        comm_vars=list(comm_enc),
        sc1=sc_proof(sc1_encs, sc1_z, sc1_zdb, mu_x, 3),
        comm_abc=(enc(mid_encs[0]), enc(mid_encs[1]), enc(mid_encs[2])),
        comm_ab=enc(mid_encs[3]),
        proof_ab=ProductProof(
            alpha=enc(mid_encs[4]),
            beta=enc(mid_encs[5]),
            delta=enc(mid_encs[6]),
            z=tuple(_int(mid_z[k]) for k in range(5)),
        ),
        eq1=EqualityProof(alpha=enc(mid_encs[7]), z=_int(mid_z[5])),
        sc2=sc_proof(sc2_encs, sc2_z, sc2_zdb, mu_y, 2),
        comm_w=enc_w,
        comm_wq=enc_wq,
        base_eq=base_eq,
        bullet=proof_bullet,
        eq2=eq2_proof,
    )
