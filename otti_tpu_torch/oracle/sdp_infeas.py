# copied from otti_tpu/oracle/sdp_infeas.py
"""Exact (rational-arithmetic) dual-infeasibility certificates for SDPs.

Purpose (VERDICT r02 next #7): the truss1 SDPLIB instance admits no
optimality certificate under the reference checker's semantics
(sdpcodegen: dual slack S = C - sum_i y_i A_i must be PSD) because the
dual LMI  S(y) >= 0  is INFEASIBLE.  Round 2 supported that claim with a
Nelder-Mead search; this module replaces the numerics with a
Farkas-style certificate checked in EXACT rational arithmetic:

    exists X:  X >= 0  (exactly, rational LDL),
               <A_i, X> = 0 for all i  (exactly),
               <C, X> < 0  (exactly).

Such an X refutes every y at once:  were S(y) >= 0, then
0 <= <S(y), X> = <C, X> - sum_i y_i <A_i, X> = <C, X> < 0 — contradiction.
Quantitatively, lambda_min(S(y)) <= <C, X> / tr(X) < 0 for every y.

The candidate X is found numerically (our own interior-point oracle on
min <C,X> s.t. <A_i,X> = 0, tr X = 1, X >= 0), then PROJECTED exactly
onto the rational subspace {<A_i, .> = 0} via the Gram system of the
constraint matrices, so the verified object is purely rational.  The
instance data (C, A_i) are the exact rationals of the float64 values the
parser produces — the same doubles the reference's smcp-based pipeline
computes with (sdpcodegen.py:14-45).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..io.sdpa import SDPProblem


def _frac_mat(M: np.ndarray) -> list:
    """float64 matrix -> exact rational entries (Fraction(float) is exact)."""
    n, m = M.shape
    return [[Fraction(float(M[i, j])) for j in range(m)] for i in range(n)]


def _frob(A: list, B: list) -> Fraction:
    return sum(
        A[i][j] * B[i][j] for i in range(len(A)) for j in range(len(A))
    )


def _solve_rational(G: list, v: list) -> list:
    """Solve G a = v exactly (symmetric PSD G; dependent rows dropped).

    Gaussian elimination over Fractions; for rows eliminated to zero the
    rhs must be zero too (guaranteed when v lies in range(G), which holds
    for Gram systems by construction)."""
    m = len(G)
    A = [row[:] + [v[i]] for i, row in enumerate(G)]
    piv_cols = []
    r = 0
    for c in range(m):
        piv = next((i for i in range(r, m) if A[i][c] != 0), None)
        if piv is None:
            continue
        A[r], A[piv] = A[piv], A[r]
        inv = 1 / A[r][c]
        A[r] = [x * inv for x in A[r]]
        for i in range(m):
            if i != r and A[i][c] != 0:
                f = A[i][c]
                A[i] = [x - f * y for x, y in zip(A[i], A[r])]
        piv_cols.append(c)
        r += 1
    a = [Fraction(0)] * m
    for row_idx, c in enumerate(piv_cols):
        a[c] = A[row_idx][m]
    return a


def is_psd_exact(X: list) -> bool:
    """Exact PSD test of a rational symmetric matrix (pivoted LDL).

    Recursively: a negative diagonal entry refutes PSD; a zero diagonal
    entry forces its whole row/column to vanish (else a 2x2 minor is
    negative); otherwise pivot on a positive diagonal entry and recurse
    on the Schur complement.  All arithmetic is exact."""
    X = [row[:] for row in X]
    n = len(X)
    idx = list(range(n))
    while idx:
        # pick the largest diagonal entry as pivot (numerically harmless,
        # exact anyway; helps termination on rank-deficient inputs)
        k = max(idx, key=lambda i: X[i][i])
        if X[k][k] < 0:
            return False
        if X[k][k] == 0:
            if any(X[k][j] != 0 for j in idx):
                return False
            idx.remove(k)
            continue
        d = X[k][k]
        for i in idx:
            if i == k:
                continue
            f = X[i][k] / d
            for j in idx:
                if j == k:
                    continue
                X[i][j] -= f * X[k][j]
        idx.remove(k)
    return True


def check_certificate(prob: SDPProblem, X: list) -> dict:
    """Exact verification of a rational dual-infeasibility witness.

    Returns the verdict plus the exact quantities; ``refutes`` is True
    iff X >= 0, <A_i,X> = 0 for all i, and <C,X> < 0 — which proves NO
    dual-feasible y (and hence no reference-style optimality certificate)
    exists for this instance."""
    C = _frac_mat(prob.C)
    ortho = all(
        _frob(_frac_mat(Ai), X) == 0 for Ai in prob.A
    )
    obj = _frob(C, X)
    psd = is_psd_exact(X)
    tr = sum(X[i][i] for i in range(len(X)))
    return {
        "psd": psd,
        "orthogonal": ortho,
        "objective": obj,
        "trace": tr,
        "refutes": psd and ortho and obj < 0 and tr > 0,
        # for every y: lambda_min(C - sum y_i A_i) <= objective / trace
        "lambda_min_bound": obj / tr if tr > 0 else None,
    }


def find_certificate(
    prob: SDPProblem, max_denominator: int = 10**8
) -> list | None:
    """Numerical candidate + exact rational projection.

    Solves  min <C,X> s.t. <A_i,X> = 0, tr X = 1, X >= 0  with the
    in-repo interior-point oracle; if the optimum is negative, the
    (interior) solution is rationalized and projected exactly onto
    {<A_i, .> = 0}.  Returns the rational witness or None."""
    from . import sdp_oracle

    n, m = prob.n, prob.m
    aug = SDPProblem(
        name=prob.name + ":infeas",
        n=n,
        m=m + 1,
        C=prob.C.copy(),
        A=[Ai.copy() for Ai in prob.A] + [np.eye(n)],
        b=np.concatenate([np.zeros(m), [1.0]]),
    )
    X_num, _, _ = sdp_oracle.solve(aug)
    if float(np.vdot(prob.C, X_num)) >= 0:
        return None

    # rationalize, symmetrize, project exactly onto the A-orthogonal space
    Xr = [
        [
            Fraction(float((X_num[i, j] + X_num[j, i]) / 2.0)).limit_denominator(
                max_denominator
            )
            for j in range(n)
        ]
        for i in range(n)
    ]
    As = [_frac_mat(Ai) for Ai in prob.A]
    G = [[_frob(Ai, Aj) for Aj in As] for Ai in As]
    v = [_frob(Ai, Xr) for Ai in As]
    alpha = _solve_rational(G, v)
    X = [
        [
            Xr[i][j] - sum(alpha[k] * As[k][i][j] for k in range(m))
            for j in range(n)
        ]
        for i in range(n)
    ]
    return X
