# copied from otti_tpu/oracle/lp_oracle.py
"""LP witness oracle: primal + dual solutions via scipy/HiGHS.

Replaces the reference's lp_solve 5.5 `__GADGET_lpsolve` witness oracle
(SURVEY.md §2.1 deps row, §3.4): solve the MPS instance at witness time,
outside the proof.  Soundness never depends on the oracle — the R1CS
checks the certificate.

Returns (x, y) with the duality-gap property c.x == b.y (strong duality;
row duals only — the reference's certificate likewise ignores bound duals,
SURVEY.md §3.1 NOTE on dual constraints).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog

from ..io.mps import LPProblem, scipy_bounds


def solve(prob: LPProblem):
    """-> (x[n_vars], y[n_rows], optimum) for min c.x s.t. rows, bounds."""
    A_ub, b_ub, ub_rows = [], [], []
    A_eq, b_eq, eq_rows = [], [], []
    for i, sense in enumerate(prob.row_senses):
        if sense == "E":
            A_eq.append(prob.A[i])
            b_eq.append(prob.rhs[i])
            eq_rows.append(i)
        elif sense == "L":
            A_ub.append(prob.A[i])
            b_ub.append(prob.rhs[i])
            ub_rows.append(i)
        else:  # G: -a.x <= -b
            A_ub.append(-prob.A[i])
            b_ub.append(-prob.rhs[i])
            ub_rows.append(i)

    res = linprog(
        c=prob.c,
        A_ub=np.asarray(A_ub) if A_ub else None,
        b_ub=np.asarray(b_ub) if b_ub else None,
        A_eq=np.asarray(A_eq) if A_eq else None,
        b_eq=np.asarray(b_eq) if b_eq else None,
        bounds=scipy_bounds(prob),
        method="highs",
    )
    if not res.success:
        raise RuntimeError(f"LP oracle failed on {prob.name}: {res.message}")

    x = np.asarray(res.x)
    y = np.zeros(prob.n_rows)
    # HiGHS marginals: dual values for the rows as passed; G rows were
    # negated so their duals flip sign back.
    if ub_rows:
        marg = np.asarray(res.ineqlin.marginals)
        for k, i in enumerate(ub_rows):
            y[i] = marg[k] if prob.row_senses[i] == "L" else -marg[k]
    if eq_rows:
        marg = np.asarray(res.eqlin.marginals)
        for k, i in enumerate(eq_rows):
            y[i] = marg[k]
    # scipy/HiGHS sign convention (deterministic, verified on the Netlib
    # suites): marginals are the shadow prices d(f*)/d(b), so for a min
    # problem strong duality reads c.x == b.y directly — no sign flip.
    # Guard with a relative gap check rather than flipping empirically
    # (a near-zero-objective instance must not silently change statement).
    gap = abs(float(prob.c @ x) - float(prob.rhs @ y))
    norm = 1.0 + abs(float(prob.c @ x))
    if gap > 1e-5 * norm:
        raise RuntimeError(
            f"LP oracle on {prob.name}: duality gap {gap:.3g} "
            "(bound duals unsupported by the row-only certificate?)"
        )
    return x, y, float(res.fun)
