# copied from otti_tpu/codegen/sdp_cert.py
"""SDP optimality certificate -> R1CS (reference sdpcodegen parity).

Statement (sdpcodegen template, SURVEY.md §3.2): witness (X, y, Lx, Ls)
satisfies, within epsilon = 1.0e-2 (sdpcodegen.py:98),
  * primal feasibility:   <A_i, X> = b_i                 (dot_calc / a_x)
  * primal PSD witness:   X = Lx Lx^T, Lx lower-tri      (chol1)
  * dual slack:           S := C - sum_i y_i A_i          (s_mat, linear)
  * dual PSD witness:     S = Ls Ls^T, Ls lower-tri      (chol2)
  * complementary slack:  <S, X> = 0                      (gap)
The reference unrolls all of this into O(N^3) scalar C statements that
CirC bit-blasts; here each product is one R1CS mul gate and each epsilon
comparison one or two range checks.

Fixed-point scales: inputs (C, A, b) and witness entries carry scale
S = 2^frac_bits; matrix products live at S^2 and the gap at S^3, with the
tolerance scaled to match — the *same* certificate, exactly checked over
integers (SURVEY.md §7.4 item 3).
"""

from __future__ import annotations

import math

import numpy as np

from ..io.sdpa import SDPProblem
from .builder import Builder, LinComb, ZERO

EPSILON = 1.0e-2  # sdpcodegen.py:98
DEFAULT_FRAC_BITS = 20
# default magnitude cap 2^17 ~= 1.3e5 on every witness entry (X, y, Lx,
# Ls): ~3x headroom over the largest SDPLIB full-suite witness magnitude
# (hinf9: max|X| = 4.1e4).  A statement parameter, like epsilon.
DEFAULT_CAP_BITS = 17


def _sc(v: float, S: int) -> int:
    # S is a power of two, so v*S is an exact IEEE op: no rounding here
    return int(round(v * S))


def pick_frac_bits(
    prob: SDPProblem,
    epsilon: float = EPSILON,
    cap_bits: int = DEFAULT_CAP_BITS,
) -> int:
    """Canonical fixed-point precision (instance + statement params only).

    The S^3-scale gap sum accumulates ~n^2 products; with every witness
    entry bounded by cap = 2^cap_bits the quantization error is
    ~n^2 * cap * (1 + m*cap + max_i sum|A_i|) * 2^-f; choose f so it
    stays under epsilon/8."""
    import math as _m

    n, m = prob.n, prob.m
    cap = float(1 << cap_bits)
    suma = max(
        (float(np.abs(Ai).sum()) for Ai in prob.A),
        default=1.0,
    )
    sumc = float(np.abs(prob.C).sum())
    sens = (n * n + 1) * cap * (1.0 + m * cap + suma) + sumc * cap
    f = int(_m.ceil(_m.log2(8.0 * sens / epsilon)))
    return max(DEFAULT_FRAC_BITS, f)


def build(
    prob: SDPProblem,
    X: np.ndarray,
    y: np.ndarray,
    Lx: np.ndarray,
    Ls: np.ndarray,
    frac_bits: int | None = None,
    epsilon: float = EPSILON,
    cap_bits: int | None = None,
):
    """-> (R1CSShape, vars, inputs).  All-existential (no public inputs),
    matching the reference main() (sdpcodegen $xvars/$yvars/$lvars).

    CANONICAL: frac_bits and every range width derive from the instance +
    (epsilon, cap_bits) only; all five certificate clauses are two-sided
    deq checks whose paired range checks pin the value to [-tol, tol], so
    the widths need only cover [0, 2*tol] — witness-magnitude-free."""
    import os

    if cap_bits is None:
        cap_bits = int(os.environ.get("OTTI_SDP_CAP_BITS", DEFAULT_CAP_BITS))
    if frac_bits is None:
        frac_bits = pick_frac_bits(prob, epsilon, cap_bits)
    n, m = prob.n, prob.m
    cap = float(1 << cap_bits)
    for name, arr in (("X", X), ("y", y), ("Lx", Lx), ("Ls", Ls)):
        if arr is not None and np.size(arr) and float(np.abs(arr).max()) > cap:
            raise ValueError(
                f"{prob.name}: witness max|{name}|={float(np.abs(arr).max()):.3g} "
                f"exceeds the cap {cap:.3g}; raise cap_bits (OTTI_SDP_CAP_BITS)"
            )
    S = 1 << frac_bits
    S2, S3 = S * S, S * S * S
    eps2 = _sc(epsilon, S) * S
    eps3 = _sc(epsilon, S) * S * S

    b = Builder(f"sdp:{prob.name}")
    xv = [[b.var(_sc(X[i, j], S)) for j in range(n)] for i in range(n)]
    yv = [b.var(_sc(y[i], S)) for i in range(m)]
    lx = [[b.var(_sc(Lx[i, j], S)) if i >= j else ZERO for j in range(n)] for i in range(n)]
    ls = [[b.var(_sc(Ls[i, j], S)) if i >= j else ZERO for j in range(n)] for i in range(n)]

    # two-sided deq width: honest range [0, 2*tol], magnitude-free
    def _w(bound: float) -> int:
        nb = int(math.ceil(math.log2(max(bound, 2.0)))) + 1
        assert nb < 250, f"range width {nb} overflows the field"
        return nb

    nbits = _w(2.0 * eps2)
    nbits3 = _w(2.0 * eps3)

    # --- primal feasibility <A_i, X> = b_i  (S^2 scale) -------------------
    for i in range(m):
        acc = ZERO
        Ai = prob.A[i]
        for r in range(n):
            for c in range(n):
                a = _sc(Ai[r, c], S)
                if a:
                    acc = acc + xv[r][c] * a
        b.deq(acc, LinComb((), (_sc(prob.b[i], S) * S) % _mod()), eps2, nbits)

    # --- X = Lx Lx^T  (xm at S^2 vs x*S) ----------------------------------
    def psd_products(L):
        """(r, c, sum_k L[r,k]*L[c,k]) for the lower-tri Cholesky witness."""
        for r in range(n):
            for c in range(n):
                acc = ZERO
                for k in range(min(r, c) + 1):
                    acc = acc + b.mul(L[r][k], L[c][k])
                yield r, c, acc

    for r, c, acc in psd_products(lx):
        b.deq(xv[r][c] * S, acc, eps2, nbits)

    # --- dual slack S = C - sum y_i A_i  (linear, S^2 scale) --------------
    s_lc = [[None] * n for _ in range(n)]
    for r in range(n):
        for c in range(n):
            acc = LinComb((), (_sc(prob.C[r, c], S) * S) % _mod())
            for i in range(m):
                a = _sc(prob.A[i][r, c], S)
                if a:
                    acc = acc - yv[i] * a
            s_lc[r][c] = acc

    # --- S = Ls Ls^T  (sm at S^2 vs s at S^2) -----------------------------
    for r, c, acc in psd_products(ls):
        b.deq(s_lc[r][c], acc, eps2, nbits)

    # --- gap <S, X> = 0  (S^3 scale) --------------------------------------
    gap = ZERO
    for r in range(n):
        for c in range(n):
            gap = gap + b.mul(s_lc[r][c], xv[r][c])
    b.deq(gap, ZERO, eps3, nbits3)

    shape, vars_, inputs = b.finalize()
    assert b.sanity_check(), f"sdp circuit unsatisfied: {prob.name}"
    return shape, vars_, inputs


def _mod() -> int:
    from .builder import MOD

    return MOD
