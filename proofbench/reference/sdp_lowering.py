"""The SDP optimality certificate as an R1CS, worked out from the SDP alone.

The statement is Otti's SDP certificate (sdpcodegen): for the problem
min <C, X> s.t. <A_i, X> = b_i, X >= 0, and its dual max b.y s.t.
S = C - sum y_i A_i >= 0, a witness (X, y, Lx, Ls) of fixed-point numbers
at scale s = 2^f such that, each within epsilon (1e-2, as the
configurations state it),

1. <A_i, X> = b_i for every i (at scale s^2);
2. X = Lx Lx^T, Lx lower triangular (s^2), so X is positive semidefinite;
3. S = C - sum y_i A_i = Ls Ls^T, Ls lower triangular (s^2);
4. <S, X> = 0 (s^3).

Every product of two witness numbers is one multiplication constraint.
Each "within epsilon" is two range checks, of t + d and of t - d, where t
is the tolerance at the clause's scale and d the difference, an affine form
of the witness: the value is written in bits, each bit held Boolean by one
constraint, and one more constraint ties the weighted bits to it.  The
width covers [0, 2t] and so depends on the tolerance, never on the witness.
f is the smallest f >= 20 at which the rounding of the gap's n^2 products,
with every witness number under the cap (2^17, as stated), stays under
epsilon / 8; so the circuit, its constraint order and its digest are fixed
by (C, A, b, epsilon, cap).

Where this departs from sdpcodegen's text (its C checker, which CirC
compiles with IEEE doubles):
- numbers are integers at scale 2^f modulo the group order, not doubles,
  and each clause is checked at the scale its products reach (s^2, s^3),
  the tolerance scaled alike;
- sdpcodegen's d_equal is |a - b| < epsilon; here -t <= a - b <= t;
- S is not a witness: its entries are affine forms of y, used in place;
- the cap on the witness, and f derived from it, are not sdpcodegen's.

Columns follow Spartan's z layout: the witness, that is X (n x n, row
by row), y, Lx and Ls (their lower triangles, row by row), then every
product and every bit in the order the clauses are written: clause 1 for
each i; clause 2 entry by entry (X_rc's products, then its two checks);
clause 3 the same way; clause 4's n^2 products, then its two checks.  At
the padded width comes the constant one.  No public inputs.
"""

from __future__ import annotations

import math

import numpy as np

from .lowering import MOD, R1CS, _width

EPSILON = 0.01
CAP_BITS = 17
MIN_FRAC_BITS = 20
ONE = -1  # the constant's column until the width is known


def frac_bits(C: np.ndarray, A: list, epsilon: float = EPSILON, cap_bits: int = CAP_BITS) -> int:
    """The gap sums n^2 products of entries under cap = 2^cap_bits with
    entries of S, each under cap (1 + m cap + max_i sum |A_i|) plus C's part:
    the smallest f >= 20 at which their rounding stays under epsilon / 8."""
    n, m = C.shape[0], len(A)
    cap = float(1 << cap_bits)
    sum_a = max((float(np.abs(Ai).sum()) for Ai in A), default=1.0)
    sens = (n * n + 1) * cap * (1.0 + m * cap + sum_a) + float(np.abs(C).sum()) * cap
    return max(MIN_FRAC_BITS, int(math.ceil(math.log2(8.0 * sens / epsilon))))


class _Circuit:
    """Rows [(a, b, c)], each a list of (column, value mod MOD), and the
    count of columns given out."""

    def __init__(self, num_vars: int):
        self.num_vars = num_vars
        self.rows: list = []

    def fresh(self, k: int) -> int:
        base = self.num_vars
        self.num_vars += k
        return base

    def product(self, a: list, b: list) -> int:
        """One multiplication constraint; the product's column."""
        out = self.fresh(1)
        self.rows.append((a, b, [(out, 1)]))
        return out

    def in_range(self, terms: list, const: int, width: int) -> None:
        """terms . z + const in [0, 2^width)."""
        base = self.fresh(width)
        for k in range(width):
            self.rows.append(([(base + k, 1)], [(base + k, 1), (ONE, MOD - 1)], []))
        lc = terms + ([(ONE, const % MOD)] if const % MOD else [])
        self.rows.append(([(base + k, 1 << k) for k in range(width)], [(ONE, 1)], lc))

    def within(self, terms: list, const: int, tol: int, width: int) -> None:
        """-tol <= terms . z + const <= tol."""
        self.in_range(terms, const + tol, width)
        self.in_range([(col, -v % MOD) for col, v in terms], tol - const, width)


def lower(C: np.ndarray, A: list, b: np.ndarray, epsilon: float = EPSILON,
          cap_bits: int = CAP_BITS) -> R1CS:
    """The certificate of the SDP (C, A_1..A_m, b), dense n x n matrices."""
    n, m = C.shape[0], len(A)
    s = 1 << frac_bits(C, A, epsilon, cap_bits)
    tol = int(round(epsilon * s))
    tol2, tol3 = tol * s, tol * s * s
    width2, width3 = _width(2.0 * tol2), _width(2.0 * tol3)

    def scaled(v: float) -> int:
        return int(round(float(v) * s))

    lower_tri = [(r, c) for r in range(n) for c in range(r + 1)]
    x = {(r, c): r * n + c for r in range(n) for c in range(n)}
    y = [n * n + i for i in range(m)]
    lx = {rc: n * n + m + k for k, rc in enumerate(lower_tri)}
    ls = {rc: n * n + m + len(lower_tri) + k for k, rc in enumerate(lower_tri)}
    circ = _Circuit(n * n + m + 2 * len(lower_tri))

    # 1. <A_i, X> = b_i
    for i in range(m):
        terms = [(x[r, c], scaled(A[i][r, c]) % MOD) for r, c in zip(*np.nonzero(A[i]))
                 if scaled(A[i][r, c])]
        circ.within(terms, -scaled(b[i]) * s, tol2, width2)

    def factor_products(L: dict, r: int, c: int) -> list:
        return [circ.product([(L[r, k], 1)], [(L[c, k], 1)]) for k in range(min(r, c) + 1)]

    # 2. X = Lx Lx^T
    for r in range(n):
        for c in range(n):
            prods = factor_products(lx, r, c)
            circ.within([(x[r, c], s)] + [(p, MOD - 1) for p in prods], 0, tol2, width2)

    # S = C - sum y_i A_i: (terms, constant) an entry
    slack = {}
    for r in range(n):
        for c in range(n):
            terms = [(y[i], -scaled(A[i][r, c]) % MOD) for i in range(m) if scaled(A[i][r, c])]
            slack[r, c] = (terms, scaled(C[r, c]) * s % MOD)

    # 3. S = Ls Ls^T
    for r in range(n):
        for c in range(n):
            prods = factor_products(ls, r, c)
            terms, const = slack[r, c]
            circ.within(terms + [(p, MOD - 1) for p in prods], const, tol2, width2)

    # 4. <S, X> = 0
    gap = []
    for r in range(n):
        for c in range(n):
            terms, const = slack[r, c]
            gap.append(circ.product(terms + ([(ONE, const)] if const else []), [(x[r, c], 1)]))
    circ.within([(p, 1) for p in gap], 0, tol3, width3)

    r1cs = R1CS(circ.num_vars, [])
    one = r1cs.one
    r1cs.rows = [tuple([(one if col == ONE else col, v) for col, v in t] for t in row)
                 for row in circ.rows]
    r1cs.num_cons = len(r1cs.rows)
    return r1cs
