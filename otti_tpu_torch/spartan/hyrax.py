"""Hyrax polynomial-commitment openings, batched by a random linear
combination (port of otti_tpu/spartan/hyrax.py).

Several committed polynomials over the same hypercube, all evaluated at the
same point, open through one combination: one u-vector, and either that
vector revealed (``open_rlc``/``verify_rlc``) or the log-sized bullet
argument on it (``open_rlc_bullet``/``verify_rlc_bullet``).  Plain flavour:
blinds zero.  Commitments and the row combination run on the polynomial's
device; the checks are host MSMs.
"""

from __future__ import annotations

import torch

from ..field.fields import SCALAR
from ..native import msm_host, ristretto_decode_host
from ..refimpl import numeric as ref

from ..field import ops as F
from . import bullet, commitments, mle
from .nizk import _eq_weights, _row_combine, _vec

L_ORD = ref.L


def hyrax_dims(n: int):
    """Table length -> (mu_rows, mu_cols) with cols >= rows."""
    mu = (n - 1).bit_length() if n > 1 else 0
    mu_cols = (mu + 1) // 2
    return mu - mu_cols, mu_cols


def commit_poly(poly_dev: torch.Tensor, label: bytes) -> list:
    """[2^mu, 22] dense MLE -> list of row-commitment encodings (blind 0)."""
    mu_rows, mu_cols = hyrax_dims(poly_dev.shape[0])
    W = poly_dev.reshape(1 << mu_rows, 1 << mu_cols, -1)
    return commitments.encode_points(commitments.commit_rows(W, [0] * (1 << mu_rows), label))


def open_rlc(polys_dev: list, weights: list, point: list) -> list:
    """u-vector opening the combination of ``polys_dev`` at ``point``:
    u[c] = sum_r eq_L[r] * Q[r, c] with Q = sum_k w_k P_k."""
    mu_rows, mu_cols = hyrax_dims(polys_dev[0].shape[0])
    w = _vec([x % L_ORD for x in weights], polys_dev[0].device)
    q = F.sum_reduce(SCALAR, F.mul(SCALAR, torch.stack(list(polys_dev)), w[:, None, :]), axis=0)
    Q = q.reshape(1 << mu_rows, 1 << mu_cols, -1)
    return F.to_ints(SCALAR, _row_combine(Q, point[:mu_rows]))


def _combined_rows(comm_lists: list, weights: list):
    """Row by row sum_k w_k C_k[i] of the commitment lists (host points), or
    None if an encoding does not decode."""
    combined = []
    for i in range(len(comm_lists[0])):
        pts = [ristretto_decode_host(cl[i]) for cl in comm_lists]
        if any(p is None for p in pts):
            return None
        combined.append(msm_host(pts, [w % L_ORD for w in weights]))
    return combined


def verify_rlc(comm_lists: list, weights: list, point: list, claimed_vals: list,
               u_ints: list, label: bytes) -> bool:
    """Check the revealed opening: (a) sum_i L_i C_i == commit(u); (b)
    <u, eq_R(point)> == sum_k w_k * claimed_k."""
    n_rows = len(comm_lists[0])
    mu_rows = (n_rows - 1).bit_length() if n_rows > 1 else 0
    combined = _combined_rows(comm_lists, weights)
    if combined is None:
        return False
    lhs = msm_host(combined, _eq_weights(point[:mu_rows]))
    G, _ = commitments.gen_points_host(len(u_ints), label)
    if not lhs.ristretto_eq(msm_host(list(G), list(u_ints))):
        return False
    Rw = _eq_weights(point[mu_rows:])
    ip = sum(u * r for u, r in zip(u_ints, Rw)) % L_ORD
    return ip == sum(w * v for w, v in zip(weights, claimed_vals)) % L_ORD


def open_rlc_bullet(polys_dev: list, weights: list, point: list, t, label: bytes):
    """Log-sized opening: prove <u, eq_R(point)> = sum_k w_k claim_k with
    the transparent bullet argument of the base NIZK's opening.  The verifier
    derives the commitment to u from the row commitments, so 2 log2(cols) + 3
    group elements go on the wire and u does not."""
    u_ints = open_rlc(polys_dev, weights, point)
    mu_rows, mu_cols = hyrax_dims(polys_dev[0].shape[0])
    R = _eq_weights(point[mu_rows:])
    G, H = commitments.gen_points_host(1 << mu_cols, label)
    Q = bullet.q_point_host(label)
    return bullet.prove(t, list(G), H, Q, u_ints, R, 0, rng=None)


def verify_rlc_bullet(comm_lists: list, weights: list, point: list, claimed_vals: list,
                      proof, label: bytes, t) -> bool:
    """C_u = sum_i L_i (sum_k w_k C_k[i]); P = C_u + (sum_k w_k claim_k) Q;
    the bullet check of <u, eq_R> against P."""
    n_rows = len(comm_lists[0])
    mu_rows = (n_rows - 1).bit_length() if n_rows > 1 else 0
    combined = _combined_rows(comm_lists, weights)
    if combined is None:
        return False
    Lw = _eq_weights(point[:mu_rows])
    R = _eq_weights(point[mu_rows:])
    want = sum(w * v for w, v in zip(weights, claimed_vals)) % L_ORD
    G, H = commitments.gen_points_host(len(R), label)
    Q = bullet.q_point_host(label)
    P = msm_host(combined + [Q], Lw + [want])
    return bullet.verify(t, list(G), H, Q, R, P, proof)


def eval_poly_host(poly_dev: torch.Tensor, point: list) -> int:
    """Direct MLE evaluation on the device, fetched to the host (prover side)."""
    return F.to_int(SCALAR, mle.evaluate(poly_dev, _vec(point, poly_dev.device)))
