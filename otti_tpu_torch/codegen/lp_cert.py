# copied from otti_tpu/codegen/lp_cert.py
"""LP optimality certificate -> R1CS (reference lpcodegen parity).

Statement (lpcodegen.generate, SURVEY.md §3.1): the witness (X, Y)
satisfies
  * every primal row:  sum_j a_ij X_j  {=, <=, >=}  b_i   within delta,
  * the sign constraint for every explicitly-bounded variable,
  * zero duality gap:  deq(c . X, b . Y, delta),
with delta = 0.01 (lpcodegen.py:6 — a first-class statement parameter,
SURVEY.md §5.6).  Dual feasibility rows are intentionally NOT emitted, for
parity (SURVEY.md §3.1 NOTE); pass ``full_dual=True`` for the
strengthened certificate.

Fixed-point lowering: values are scaled by S = 2^frac_bits; a row
comparison over coeff*var products lives at scale S^2 and each delta
comparator becomes one or two range checks (builder.bits).  This replaces
CirC's FP bit-blasting — the 200GB bottleneck — with ~(bits+2)
constraints per comparison.

CANONICAL CIRCUITS: every lowering parameter (frac_bits, every range
width) is derived from the *instance* plus the statement parameters
(delta, cap_bits) only — never from the witness — so two honest provers
with different oracles produce the identical R1CS and digest (the
reference's circuits likewise depend only on the instance,
lpcodegen.py:211-224).  Witness magnitudes are checked against the caps
at build time and rejected with a clear error if they do not fit.

Width facts used:
  * two-sided ``deq(a, b, tol)`` = assert_in_pm: the PAIR of range checks
    pins a-b to [-tol, tol] regardless of the width, so its width only
    needs to cover the honest value range [0, 2*tol] — independent of
    row magnitudes;
  * one-sided ``dge``/``dle`` widths must cover the honest slack, bounded
    by sum_j |a_ij| * cap_j + |b_i| + delta from the per-variable caps.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..io.mps import LPProblem, scipy_bounds, sign_constraints
from .builder import Builder, LinComb, ZERO

DELTA = 0.01  # lpcodegen.py:6
DEFAULT_FRAC_BITS = 24
# default magnitude cap 2^22 ~= 4.2e6 on |X_j|, |Y_i|: ~4x headroom over
# the largest Netlib witness magnitude (agg.mps: max|x| = 9.6e5).  A
# statement parameter (like delta): override via cap_bits / --var-cap-bits.
DEFAULT_CAP_BITS = 22


def _scaled(v: float, S: int) -> int:
    # S is a power of two, so v*S is an exact IEEE op: no rounding here
    return int(round(v * S))


def var_caps(prob: LPProblem, cap_bits: int = DEFAULT_CAP_BITS) -> np.ndarray:
    """Per-variable magnitude caps, from instance bounds only.

    Variables with finite MPS bounds get the (power-of-two rounded,
    2x headroom) bound; free/one-sided variables get the default cap.
    """
    default = float(1 << cap_bits)
    caps = np.full(prob.n_vars, default)
    for j, (lo, hi) in enumerate(scipy_bounds(prob)):
        if lo is not None and hi is not None:
            mag = 2.0 * max(abs(lo), abs(hi), 1.0)
            caps[j] = min(default, 2.0 ** math.ceil(math.log2(mag)))
    return caps


def pick_frac_bits(
    prob: LPProblem,
    delta: float = DELTA,
    cap_bits: int = DEFAULT_CAP_BITS,
) -> int:
    """Canonical fixed-point precision (instance + statement params only):
    the rounding error of a scaled row is bounded by ~2^-f * L1 with
    L1 = max over checks of (sum|coeff| + sum of active var caps); choose
    f so the error is < delta/8 (the tolerance must dominate the
    quantization noise, not vice versa)."""
    caps = var_caps(prob, cap_bits)
    cap_y = float(1 << cap_bits)
    l1 = 1.0
    for i in range(prob.n_rows):
        act = prob.A[i] != 0
        l1 = max(
            l1,
            float(np.abs(prob.A[i]).sum() + caps[act].sum()) + abs(prob.rhs[i]),
        )
    act_c = prob.c != 0
    l1 = max(l1, float(np.abs(prob.c).sum() + caps[act_c].sum()))
    n_act_rhs = int((prob.rhs != 0).sum())
    l1 = max(l1, float(np.abs(prob.rhs).sum()) + cap_y * max(n_act_rhs, 1))
    return max(DEFAULT_FRAC_BITS, int(math.ceil(math.log2(8.0 * l1 / delta))))


def _nbits_for(bound_scaled: float) -> int:
    """Width covering honest values in [0, bound_scaled]."""
    nb = int(math.ceil(math.log2(max(bound_scaled, 2.0)))) + 1
    assert nb < 250, f"range width {nb} overflows the field"
    return nb


def build(
    prob: LPProblem,
    x: np.ndarray,
    y: np.ndarray,
    frac_bits: int | None = None,
    delta: float = DELTA,
    full_dual: bool = False,
    cap_bits: int | None = None,
):
    """-> (R1CSShape, vars, inputs).  No public inputs: the instance is the
    statement, (X, Y) are existential (lpcodegen cvargen/__GADGET_exist)."""
    if cap_bits is None:
        cap_bits = int(os.environ.get("OTTI_VAR_CAP_BITS", DEFAULT_CAP_BITS))
    if frac_bits is None:
        frac_bits = pick_frac_bits(prob, delta, cap_bits)
    caps = var_caps(prob, cap_bits)
    cap_y = float(1 << cap_bits)

    # witness-fit check (completeness guard; the circuit never sees these)
    for j in range(prob.n_vars):
        if abs(float(x[j])) > caps[j]:
            raise ValueError(
                f"{prob.name}: witness |x[{j}]|={abs(float(x[j])):.3g} exceeds "
                f"the cap {caps[j]:.3g}; raise cap_bits (--var-cap-bits)"
            )
    for i in range(prob.n_rows):
        if abs(float(y[i])) > cap_y:
            raise ValueError(
                f"{prob.name}: witness |y[{i}]|={abs(float(y[i])):.3g} exceeds "
                f"the cap {cap_y:.3g}; raise cap_bits (--var-cap-bits)"
            )

    S = 1 << frac_bits
    S2 = S * S
    d_s2 = _scaled(delta, S) * S  # delta at S^2 scale
    d_s1 = _scaled(delta, S)  # delta at S scale

    b = Builder(f"lp:{prob.name}")
    X = [b.var(_scaled(v, S)) for v in x]
    Y = [b.var(_scaled(v, S)) for v in y]

    # two-sided (deq) width: honest range is [0, 2*tol] — magnitude-free
    nbits_eq2 = _nbits_for(2.0 * d_s2)
    nbits_eq1 = _nbits_for(2.0 * d_s1)

    def row_lc(coeffs, vars_) -> LinComb:
        acc = ZERO
        for j, a in enumerate(coeffs):
            if a == 0.0:
                continue
            acc = acc + vars_[j] * _scaled(a, S)
        return acc

    def row_slack_bits(coeffs, rhs_abs: float, caps_vec) -> int:
        """One-sided width from instance data + caps (S^2 scale)."""
        act = coeffs != 0
        bound = float(np.abs(coeffs) @ np.where(act, caps_vec, 0.0)) + rhs_abs + delta + 1.0
        return _nbits_for(2.0 * bound * S2)

    # primal rows (Constraint.show_delta semantics)
    for i in range(prob.n_rows):
        if not prob.A[i].any():
            continue  # is_zero rows skipped (lpcodegen.py:144)
        lhs = row_lc(prob.A[i], X)
        rhs = _scaled(prob.rhs[i], S) * S  # S^2 scale
        sense = prob.row_senses[i]
        if sense == "E":
            b.deq(lhs, LinComb((), rhs % b_mod()), d_s2, nbits_eq2)
        elif sense == "G":
            nb = row_slack_bits(prob.A[i], abs(prob.rhs[i]), caps)
            b.dge(lhs, LinComb((), rhs % b_mod()), d_s2, nb)
        else:
            nb = row_slack_bits(prob.A[i], abs(prob.rhs[i]), caps)
            b.dle(lhs, LinComb((), rhs % b_mod()), d_s2, nb)

    # sign constraints (RangeConstraint.show_delta semantics, S scale)
    sgn = sign_constraints(prob)
    for j, s in sgn.items():
        mag_bits = _nbits_for((caps[j] + delta + 1.0) * 2.0 * S)
        if s == "+":
            b.dge(X[j], ZERO, d_s1, mag_bits)
        else:
            b.dle(X[j], ZERO, d_s1, mag_bits)

    # duality gap: deq(c.X, rhs.Y, delta) at S^2 scale
    pobj = row_lc(prob.c, X)
    dobj = row_lc(prob.rhs, Y)
    b.deq(pobj, dobj, d_s2, nbits_eq2)

    if full_dual:
        # strengthened mode (beyond reference parity): dual feasibility
        # rows  sum_i a_ij Y_i {<=,=,>=} c_j, with the sense taken from the
        # variable's *solver* bounds (x>=0 by MPS default -> A^T y <= c);
        # variables with other finite bounds carry bound-dual terms the
        # row-only certificate cannot see, so they are skipped.
        sb = scipy_bounds(prob)
        caps_y_vec = np.full(prob.n_rows, cap_y)
        for j in range(prob.n_vars):
            col = prob.A[:, j]
            if not col.any() and prob.c[j] == 0.0:
                continue
            lo, hi = sb[j]
            lhs = row_lc(col, Y)
            rhs_j = _scaled(prob.c[j], S) * S
            nb = row_slack_bits(col, abs(prob.c[j]), caps_y_vec)
            if lo == 0.0 and hi is None:
                b.dle(lhs, LinComb((), rhs_j % b_mod()), d_s2, nb)
            elif hi == 0.0 and lo is None:
                b.dge(lhs, LinComb((), rhs_j % b_mod()), d_s2, nb)
            elif lo is None and hi is None:
                b.deq(lhs, LinComb((), rhs_j % b_mod()), d_s2, nbits_eq2)
            # else: finite/shifted bounds -> skip (bound duals not modeled)

    shape, vars_, inputs = b.finalize()
    assert b.sanity_check(), f"lp circuit unsatisfied: {prob.name}"
    return shape, vars_, inputs


def b_mod() -> int:
    from .builder import MOD

    return MOD
