"""SPARK: sparse-matrix polynomial commitments for SNARK mode (port of
otti_tpu/spartan/spark.py).

The three matrices live in one power-of-two cube: each matrix's entries
padded to a common block size n_blk, blocks A|B|C|0 selected by the two top
(MSB-first) variables.  The per-entry advice E_row[i] = eq(rx, row[i]),
E_col[i] = eq(ry, col[i]) is tied to the committed (row, col, val)
description by a logup (log-derivative) lookup argument:

  preprocessing: Hyrax-commit the dense MLEs row_f, col_f, val.
  eval proof for (eA, eB, eC) = (A~, B~, C~)(rx, ry):
    1. advice E_row, E_col and the multiplicities m_row, m_col; commit.
    2. challenges (gamma, tau) per side; inverse advice
       invR[i] = 1/(tau - row_f[i] - gamma E_row[i]),
       invT[a] = 1/(tau - id(a) - gamma eq_rx[a]); commit.
    3. one degree-4 sumcheck over the entry cube for
       sum sel val E_row E_col = c1a eA + c1b eB + c1c eC, both entry-side
       zero-checks and the entry-side logup sums; one cubic sumcheck per
       table cube (rows, cols) for the table-side zero-check and sum.
       Logup identity: sum_i invR[i] == sum_a m[a] invT[a].
    4. one combined Hyrax opening of the 7 entry-cube polynomials and one of
       2 polynomials per table side; the verifier evaluates eq, id and sel in
       closed form.

Every label, the order of appends and challenges and the order of
``entry_claims`` are the JAX package's: the proofs are byte-identical.  The
three sumchecks run as the JAX package runs them, by
``sumcheck.prove_custom_device``: every round on the device (kernel K5 with
the combinations below, the device transcript) and one fetch a sumcheck.
The rest of the device work is torch ops on the field multiply kernel
(gathers, the inversions of ``field.ops.inv``, Hyrax rows); the
prover-retained tensors of a ``SparkCommitment`` live on the R1CS's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import metrics
from ..field.fields import N_LIMBS, SCALAR
from ..transcript.merlin import Transcript

from ..field import ops as F
from . import hyrax, mle, r1cs, sumcheck
from .nizk import _eq_point, _sb, _vec

MOD = SCALAR.modulus
GENS = b"gens_spark"


# ---------------------------------------------------------------------------
# round combinations (registered once); exts are [..., 22], consts [22].
# csrc/custom_round.cu (K5) computes the same two on the card.
# ---------------------------------------------------------------------------

def _comb_entry(consts, exts):
    c2, c3, c4, c5 = consts
    sel, val, er, ec, eqn, invr, gr, invc, gc = exts
    one = F.ones(SCALAR, val.shape[:-1], val.device)
    t1 = F.mul(SCALAR, F.mul(SCALAR, F.mul(SCALAR, sel, val), er), ec)
    t2 = F.mul(SCALAR, eqn, F.sub(SCALAR, F.mul(SCALAR, invr, gr), one))
    t3 = F.mul(SCALAR, eqn, F.sub(SCALAR, F.mul(SCALAR, invc, gc), one))
    out = F.add(SCALAR, t1, F.mul(SCALAR, t2, c2))
    out = F.add(SCALAR, out, F.mul(SCALAR, t3, c3))
    out = F.add(SCALAR, out, F.mul(SCALAR, invr, c4))
    return F.add(SCALAR, out, F.mul(SCALAR, invc, c5))


def _comb_table(consts, exts):
    c6, c7 = consts
    m, invt, eqx, gt = exts
    one = F.ones(SCALAR, m.shape[:-1], m.device)
    t1 = F.mul(SCALAR, m, invt)
    t2 = F.mul(SCALAR, eqx, F.sub(SCALAR, F.mul(SCALAR, invt, gt), one))
    return F.add(SCALAR, F.mul(SCALAR, t1, c6), F.mul(SCALAR, t2, c7))


sumcheck.register_comb("spark_entry4", _comb_entry)
sumcheck.register_comb("spark_table", _comb_table)


# ---------------------------------------------------------------------------
# commitment (preprocessing): one combined cube for A|B|C|0
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparkCommitment:
    mu_n: int  # log2 of the combined cube (= mu_blk + 2)
    comm_row: list
    comm_col: list
    comm_val: list
    mu_x: int
    mu_y: int
    # prover-retained dense data (combined layout)
    row_idx: np.ndarray
    col_idx: np.ndarray
    row_f: torch.Tensor
    col_f: torch.Tensor
    val: torch.Tensor

    def transcript_bytes(self) -> bytes:
        out = b""
        for lst in (self.comm_row, self.comm_col, self.comm_val):
            for enc in lst:
                out += enc
        return out


def commit(dev: r1cs.R1CSDevice) -> SparkCommitment:
    """Commit A|B|C in one block-aligned cube: each matrix's entries are
    padded to n_blk = next_pow2(max nnz); block b = matrix b, block 3 zero.
    MSB-first variable order, so the top two variables select the block and
    per-matrix sums come from the multilinear selector
    sel(X) = sum_b c_b eq_b(X_top) (closed form for the verifier).  Padded
    entries have row 0, col 0, val 0."""
    device = dev.device
    n_blk = r1cs._next_pow2(max(dev.mats[w][0].shape[0] for w in range(3)))
    n_tot = 4 * n_blk
    row_idx = np.zeros(n_tot, np.int32)
    col_idx = np.zeros(n_tot, np.int32)
    val = torch.zeros((n_tot, N_LIMBS), dtype=torch.int32, device=device)
    for which in range(3):
        rows, cols, vals = dev.mats[which]
        nnz = rows.shape[0]
        row_idx[which * n_blk : which * n_blk + nnz] = rows.cpu().numpy()
        col_idx[which * n_blk : which * n_blk + nnz] = cols.cpu().numpy()
        val[which * n_blk : which * n_blk + nnz] = vals
    row_f = _int_vec_to_field(row_idx, device)
    col_f = _int_vec_to_field(col_idx, device)
    return SparkCommitment(
        mu_n=(n_tot - 1).bit_length(),
        comm_row=hyrax.commit_poly(row_f, GENS),
        comm_col=hyrax.commit_poly(col_f, GENS),
        comm_val=hyrax.commit_poly(val, GENS),
        mu_x=(dev.num_cons - 1).bit_length(),
        mu_y=(dev.num_z - 1).bit_length(),
        row_idx=row_idx,
        col_idx=col_idx,
        row_f=row_f,
        col_f=col_f,
        val=val,
    )


def _int_vec_to_field(idx: np.ndarray, device="cpu") -> torch.Tensor:
    """Non-negative integers below 2^36 -> limb vectors (three limbs)."""
    idx = np.asarray(idx, np.int64)
    out = np.zeros((len(idx), N_LIMBS), np.int32)
    out[:, 0] = idx & 0xFFF
    out[:, 1] = (idx >> 12) & 0xFFF
    out[:, 2] = idx >> 24
    return torch.from_numpy(out).to(device)


# ---------------------------------------------------------------------------
# eval proof
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparkSideProof:
    """Logup table side (rows or cols), covering all three matrices."""

    comm_m: list
    comm_invT: list
    s_T: int  # claimed sum m*invT
    rounds: list
    claim_m: int
    claim_invT: int
    opening: object  # bullet.BulletOpeningProof


@dataclasses.dataclass
class SparkEvalProof:
    """Combined A/B/C evaluation proof (one entry cube, one side each)."""

    comm_E_row: list
    comm_E_col: list
    comm_invR_row: list
    comm_invR_col: list
    s_R_row: int
    s_R_col: int
    entry_rounds: list
    entry_claims: dict  # val, e_row, e_col, inv_r_row, inv_r_col, row, col
    entry_opening: object  # bullet.BulletOpeningProof
    side_row: SparkSideProof
    side_col: SparkSideProof


def _counts_to_field(idx: np.ndarray, size: int, device="cpu") -> torch.Tensor:
    """Multiplicities of the indices (the padding counts into entry 0)."""
    return _int_vec_to_field(np.bincount(idx, minlength=size), device)


def _id_mle_eval(point: list, mu: int) -> int:
    """MLE of a -> a over the mu-cube, at ``point`` (MSB-first)."""
    acc = 0
    for j, p in enumerate(point):
        acc = (acc + p * (1 << (mu - 1 - j))) % MOD
    return acc


def _sel_mle_eval(weights: list, point2: list) -> int:
    """MLE of the block-selector table at the top-two-variable point:
    sum_b w_b * eq(bits(b), point2)."""
    acc = 0
    for b, w in enumerate(weights):
        hi, lo = (b >> 1) & 1, b & 1
        e = ((point2[0] if hi else (1 - point2[0])) % MOD) * (
            (point2[1] if lo else (1 - point2[1])) % MOD
        ) % MOD
        acc = (acc + w * e) % MOD
    return acc


def _sel_table(weights: list, n_blk: int, device="cpu") -> torch.Tensor:
    """[4 * n_blk, 22] block-constant selector table."""
    return _vec(weights, device).repeat_interleave(n_blk, dim=0)


def _gather_table(table: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return table[torch.from_numpy(idx.astype(np.int64)).to(table.device)]


def _sum_host(x: torch.Tensor) -> int:
    return F.to_int(SCALAR, F.sum_reduce(SCALAR, x, axis=0))


def prove_eval(comm: SparkCommitment, rx: list, ry: list, claimed: tuple,  # (eA, eB, eC)
               t: Transcript, label: bytes) -> SparkEvalProof:
    device = comm.val.device
    mu_x, mu_y = comm.mu_x, comm.mu_y
    n_blk = (1 << comm.mu_n) // 4

    def scalar(x):
        return F.from_int(SCALAR, x, device)

    with metrics.timed("spark_advice"):
        eq_rx = mle.eq_table(_vec(rx, device))
        eq_ry = mle.eq_table(_vec(ry, device))
        e_row = _gather_table(eq_rx, comm.row_idx)
        e_col = _gather_table(eq_ry, comm.col_idx)
        m_row = _counts_to_field(comm.row_idx, 1 << mu_x, device)
        m_col = _counts_to_field(comm.col_idx, 1 << mu_y, device)

        comm_E_row = hyrax.commit_poly(e_row, GENS)
        comm_E_col = hyrax.commit_poly(e_col, GENS)
        comm_m_row = hyrax.commit_poly(m_row, GENS)
        comm_m_col = hyrax.commit_poly(m_col, GENS)
    for lbl, encs in (
        (b"E_row", comm_E_row),
        (b"E_col", comm_E_col),
        (b"m_row", comm_m_row),
        (b"m_col", comm_m_col),
    ):
        for enc in encs:
            t.append_point(label + b"/" + lbl, enc)

    gam_r = t.challenge_scalar(label + b"/gamma_row")
    tau_r = t.challenge_scalar(label + b"/tau_row")
    gam_c = t.challenge_scalar(label + b"/gamma_col")
    tau_c = t.challenge_scalar(label + b"/tau_col")

    def g_entry(row_f, e_tbl, gam, tau):
        s = F.add(SCALAR, row_f, F.mul(SCALAR, e_tbl, scalar(gam)))
        return F.sub(SCALAR, scalar(tau), s)

    with metrics.timed("spark_inverse"):
        g_row = g_entry(comm.row_f, e_row, gam_r, tau_r)
        g_col = g_entry(comm.col_f, e_col, gam_c, tau_c)
        inv_r_row = F.inv(SCALAR, g_row)
        inv_r_col = F.inv(SCALAR, g_col)

        # table side denominators
        idx_x = _int_vec_to_field(np.arange(1 << mu_x, dtype=np.int64), device)
        idx_y = _int_vec_to_field(np.arange(1 << mu_y, dtype=np.int64), device)
        gT_row = g_entry(idx_x, eq_rx, gam_r, tau_r)
        gT_col = g_entry(idx_y, eq_ry, gam_c, tau_c)
        invT_row = F.inv(SCALAR, gT_row)
        invT_col = F.inv(SCALAR, gT_col)

        comm_invR_row = hyrax.commit_poly(inv_r_row, GENS)
        comm_invR_col = hyrax.commit_poly(inv_r_col, GENS)
        comm_invT_row = hyrax.commit_poly(invT_row, GENS)
        comm_invT_col = hyrax.commit_poly(invT_col, GENS)
    for lbl, encs in (
        (b"invR_row", comm_invR_row),
        (b"invR_col", comm_invR_col),
        (b"invT_row", comm_invT_row),
        (b"invT_col", comm_invT_col),
    ):
        for enc in encs:
            t.append_point(label + b"/" + lbl, enc)

    # claimed logup sums
    s_R_row = _sum_host(inv_r_row)
    s_R_col = _sum_host(inv_r_col)
    s_T_row = _sum_host(F.mul(SCALAR, m_row, invT_row))
    s_T_col = _sum_host(F.mul(SCALAR, m_col, invT_col))
    for lbl, v in (
        (b"s_R_row", s_R_row),
        (b"s_R_col", s_R_col),
        (b"s_T_row", s_T_row),
        (b"s_T_col", s_T_col),
    ):
        t.append_scalar(label + b"/" + lbl, _sb(v))

    # ---- entry-side combined sumcheck (degree 4: sel*val*E_row*E_col) -----
    cs = [t.challenge_scalar(label + b"/c%d" % i) for i in range(1, 8)]
    c1a, c1b, c1c, c2, c3, c4, c5 = cs
    rho_n = t.challenge_vector(label + b"/rho_n", comm.mu_n)
    eA, eB, eC = claimed
    claim_e = (c1a * eA + c1b * eB + c1c * eC + c4 * s_R_row + c5 * s_R_col) % MOD
    with metrics.timed("spark_entry"):
        eq_n = mle.eq_table(_vec(rho_n, device))
        sel = _sel_table([c1a, c1b, c1c, 0], n_blk, device)
        tables = (sel, comm.val, e_row, e_col, eq_n, inv_r_row, g_row, inv_r_col, g_col)
        consts = tuple(scalar(c) for c in (c2, c3, c4, c5))
        entry_rounds, rho_star, finals, _ = sumcheck.prove_custom_device(
            claim_e, tables, consts, "spark_entry4", 4, t, label + b"/entry"
        )
        metrics.add("sumcheck_rounds", comm.mu_n)
        claims = {
            "val": finals[1],
            "e_row": finals[2],
            "e_col": finals[3],
            "inv_r_row": finals[5],
            "inv_r_col": finals[7],
            "row": hyrax.eval_poly_host(comm.row_f, rho_star),
            "col": hyrax.eval_poly_host(comm.col_f, rho_star),
        }
    order = ["val", "e_row", "e_col", "inv_r_row", "inv_r_col", "row", "col"]
    for k in order:
        t.append_scalar(label + b"/claim_" + k.encode(), _sb(claims[k]))
    d = [t.challenge_scalar(label + b"/d%d" % i) for i in range(len(order))]
    with metrics.timed("spark_opening"):
        entry_bullet = hyrax.open_rlc_bullet(
            [comm.val, e_row, e_col, inv_r_row, inv_r_col, comm.row_f, comm.col_f],
            d, rho_star, t, GENS,
        )

    # ---- table sides ------------------------------------------------------
    def table_side(side_lbl, mu_t, m_tbl, invT_tbl, gt, comm_m, comm_invT, s_T):
        c6 = t.challenge_scalar(label + side_lbl + b"/c6")
        c7 = t.challenge_scalar(label + side_lbl + b"/c7")
        rho_t = t.challenge_vector(label + side_lbl + b"/rho", mu_t)
        claim_t = c6 * s_T % MOD
        with metrics.timed("spark_tables"):
            eq_t = mle.eq_table(_vec(rho_t, device))
            rounds, sigma, finals_t, _ = sumcheck.prove_custom_device(
                claim_t, (m_tbl, invT_tbl, eq_t, gt), (scalar(c6), scalar(c7)),
                "spark_table", 3, t, label + side_lbl + b"/table",
            )
        metrics.add("sumcheck_rounds", mu_t)
        cm, ci = finals_t[0], finals_t[1]
        t.append_scalar(label + side_lbl + b"/claim_m", _sb(cm))
        t.append_scalar(label + side_lbl + b"/claim_invT", _sb(ci))
        d2 = [t.challenge_scalar(label + side_lbl + b"/d%d" % i) for i in range(2)]
        with metrics.timed("spark_opening"):
            b2 = hyrax.open_rlc_bullet([m_tbl, invT_tbl], d2, sigma, t, GENS)
        return SparkSideProof(
            comm_m=comm_m,
            comm_invT=comm_invT,
            s_T=s_T,
            rounds=rounds,
            claim_m=cm,
            claim_invT=ci,
            opening=b2,
        )

    side_row = table_side(b"/row", mu_x, m_row, invT_row, gT_row, comm_m_row, comm_invT_row,
                          s_T_row)
    side_col = table_side(b"/col", mu_y, m_col, invT_col, gT_col, comm_m_col, comm_invT_col,
                          s_T_col)

    return SparkEvalProof(
        comm_E_row=comm_E_row,
        comm_E_col=comm_E_col,
        comm_invR_row=comm_invR_row,
        comm_invR_col=comm_invR_col,
        s_R_row=s_R_row,
        s_R_col=s_R_col,
        entry_rounds=entry_rounds,
        entry_claims=claims,
        entry_opening=entry_bullet,
        side_row=side_row,
        side_col=side_col,
    )


def verify_eval(
    comm: "SparkCommitment",
    rx: list,
    ry: list,
    claimed: tuple,
    proof: SparkEvalProof,
    t: Transcript,
    label: bytes,
) -> bool:
    mu_x, mu_y = comm.mu_x, comm.mu_y
    for lbl, encs in (
        (b"E_row", proof.comm_E_row),
        (b"E_col", proof.comm_E_col),
        (b"m_row", proof.side_row.comm_m),
        (b"m_col", proof.side_col.comm_m),
    ):
        for enc in encs:
            t.append_point(label + b"/" + lbl, enc)
    gam_r = t.challenge_scalar(label + b"/gamma_row")
    tau_r = t.challenge_scalar(label + b"/tau_row")
    gam_c = t.challenge_scalar(label + b"/gamma_col")
    tau_c = t.challenge_scalar(label + b"/tau_col")
    for lbl, encs in (
        (b"invR_row", proof.comm_invR_row),
        (b"invR_col", proof.comm_invR_col),
        (b"invT_row", proof.side_row.comm_invT),
        (b"invT_col", proof.side_col.comm_invT),
    ):
        for enc in encs:
            t.append_point(label + b"/" + lbl, enc)
    for lbl, v in (
        (b"s_R_row", proof.s_R_row),
        (b"s_R_col", proof.s_R_col),
        (b"s_T_row", proof.side_row.s_T),
        (b"s_T_col", proof.side_col.s_T),
    ):
        t.append_scalar(label + b"/" + lbl, _sb(v))

    # logup sum identities
    if proof.s_R_row != proof.side_row.s_T or proof.s_R_col != proof.side_col.s_T:
        return False

    cs = [t.challenge_scalar(label + b"/c%d" % i) for i in range(1, 8)]
    c1a, c1b, c1c, c2, c3, c4, c5 = cs
    rho_n = t.challenge_vector(label + b"/rho_n", comm.mu_n)
    eA, eB, eC = claimed
    claim_e = (
        c1a * eA + c1b * eB + c1c * eC
        + c4 * proof.s_R_row + c5 * proof.s_R_col
    ) % MOD
    e_final, rho_star = sumcheck.verify_custom(
        claim_e, proof.entry_rounds, 4, t, label + b"/entry"
    )
    cl = proof.entry_claims
    order = ["val", "e_row", "e_col", "inv_r_row", "inv_r_col", "row", "col"]
    for k in order:
        t.append_scalar(label + b"/claim_" + k.encode(), _sb(cl[k]))
    d = [t.challenge_scalar(label + b"/d%d" % i) for i in range(len(order))]
    if not hyrax.verify_rlc_bullet(
        [comm.comm_val, proof.comm_E_row, proof.comm_E_col,
         proof.comm_invR_row, proof.comm_invR_col, comm.comm_row,
         comm.comm_col],
        d,
        rho_star,
        [cl[k] for k in order],
        proof.entry_opening,
        GENS,
        t,
    ):
        return False
    # final entry identity (sel evaluated in closed form on the top vars)
    eq_n_star = _eq_point(rho_n, rho_star)
    sel_star = _sel_mle_eval([c1a, c1b, c1c, 0], rho_star[:2])
    g_row_star = (tau_r - cl["row"] - gam_r * cl["e_row"]) % MOD
    g_col_star = (tau_c - cl["col"] - gam_c * cl["e_col"]) % MOD
    want = (
        sel_star * (cl["val"] * cl["e_row"] % MOD * cl["e_col"]) % MOD
        + c2 * eq_n_star % MOD * ((cl["inv_r_row"] * g_row_star - 1) % MOD)
        + c3 * eq_n_star % MOD * ((cl["inv_r_col"] * g_col_star - 1) % MOD)
        + c4 * cl["inv_r_row"]
        + c5 * cl["inv_r_col"]
    ) % MOD
    if want != e_final:
        return False

    # table sides
    def check_side(side_lbl, mu_t, sp, r_point, gam, tau):
        c6 = t.challenge_scalar(label + side_lbl + b"/c6")
        c7 = t.challenge_scalar(label + side_lbl + b"/c7")
        rho_t = t.challenge_vector(label + side_lbl + b"/rho", mu_t)
        claim_t = c6 * sp.s_T % MOD
        ef, sigma = sumcheck.verify_custom(
            claim_t, sp.rounds, 3, t, label + side_lbl + b"/table"
        )
        t.append_scalar(label + side_lbl + b"/claim_m", _sb(sp.claim_m))
        t.append_scalar(label + side_lbl + b"/claim_invT", _sb(sp.claim_invT))
        d2 = [
            t.challenge_scalar(label + side_lbl + b"/d%d" % i) for i in range(2)
        ]
        if not hyrax.verify_rlc_bullet(
            [sp.comm_m, sp.comm_invT],
            d2,
            sigma,
            [sp.claim_m, sp.claim_invT],
            sp.opening,
            GENS,
            t,
        ):
            return False
        id_star = _id_mle_eval(sigma, mu_t)
        eq_table_star = _eq_point(r_point, sigma)
        gT_star = (tau - id_star - gam * eq_table_star) % MOD
        eq_t_star = _eq_point(rho_t, sigma)
        want_t = (
            c6 * (sp.claim_m * sp.claim_invT) % MOD
            + c7 * eq_t_star % MOD * ((sp.claim_invT * gT_star - 1) % MOD)
        ) % MOD
        return want_t == ef

    if not check_side(b"/row", mu_x, proof.side_row, rx, gam_r, tau_r):
        return False
    if not check_side(b"/col", mu_y, proof.side_col, ry, gam_c, tau_c):
        return False
    return True
