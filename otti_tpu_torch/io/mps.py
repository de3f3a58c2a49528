# copied from otti_tpu/io/mps.py
"""MPS linear-program parser (replaces the reference's pysmps dependency).

Covers the feature set used by the Netlib instances shipped with the
reference (datasets/LP/MPS-{small,full}: ROWS N/E/L/G, COLUMNS, RHS,
BOUNDS UP/LO/FX/FR/MI/PL/BV; no RANGES).  Whitespace-tokenized — the
Netlib files are well-formed fixed-format.

Output mirrors what lpcodegen.parse consumed (SURVEY.md §2.1 LP codegen
row): objective vector, per-row (coeffs, sense, rhs), and per-variable
bound declarations.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LPProblem:
    name: str
    var_names: list
    row_names: list  # constraint rows only
    row_senses: list  # 'E' | 'L' | 'G'
    A: np.ndarray  # [n_rows, n_vars] dense float64
    rhs: np.ndarray  # [n_rows]
    c: np.ndarray  # [n_vars] objective
    bounds: dict  # var index -> list of (btype, value)

    @property
    def n_rows(self):
        return len(self.row_names)

    @property
    def n_vars(self):
        return len(self.var_names)


def parse_mps(path: str) -> LPProblem:
    name = ""
    section = None
    obj_row = None
    row_senses = {}
    row_order = []
    col_entries = {}  # col -> {row: val}
    col_order = []
    rhs = {}
    ranges = {}  # rowname -> range value (RANGES section)
    bounds = {}  # colname -> [(btype, value)]

    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("*"):
                continue
            if not line[0].isspace():
                parts = line.split()
                section = parts[0].upper()
                if section == "NAME" and len(parts) > 1:
                    name = parts[1]
                if section == "ENDATA":
                    break
                continue
            toks = line.split()
            if section == "ROWS":
                sense, rname = toks[0].upper(), toks[1]
                if sense == "N":
                    if obj_row is None:
                        obj_row = rname
                else:
                    row_senses[rname] = sense
                    row_order.append(rname)
            elif section == "COLUMNS":
                if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
                    continue  # integer markers — LP relaxation semantics
                col = toks[0]
                if col not in col_entries:
                    col_entries[col] = {}
                    col_order.append(col)
                for i in range(1, len(toks) - 1, 2):
                    col_entries[col][toks[i]] = float(toks[i + 1])
            elif section == "RHS":
                for i in range(1, len(toks) - 1, 2):
                    rhs[toks[i]] = float(toks[i + 1])
            elif section == "RANGES":
                for i in range(1, len(toks) - 1, 2):
                    ranges[toks[i]] = float(toks[i + 1])
            elif section == "BOUNDS":
                btype = toks[0].upper()
                col = toks[2]
                val = float(toks[3]) if len(toks) > 3 else 0.0
                bounds.setdefault(col, []).append((btype, val))

    n_rows, n_vars = len(row_order), len(col_order)
    A = np.zeros((n_rows, n_vars))
    c = np.zeros(n_vars)
    row_idx = {r: i for i, r in enumerate(row_order)}
    for j, col in enumerate(col_order):
        for rname, val in col_entries[col].items():
            if rname == obj_row:
                c[j] = val
            elif rname in row_idx:
                A[row_idx[rname], j] = val
    b = np.zeros(n_rows)
    for rname, val in rhs.items():
        if rname in row_idx:
            b[row_idx[rname]] = val

    # RANGES: a ranged row imposes lower <= ax <= upper (standard MPS
    # semantics; the reference reads these via pysmps, lpcodegen.py:163).
    # Lower each ranged row to its base inequality plus one extra row of
    # the opposite sense carrying the other bound — downstream (certificate
    # codegen, oracle) is sense-generic, so no other change is needed.
    if ranges:
        senses_by_name = dict(row_senses)
        for rname, rval in ranges.items():
            if rname not in row_idx:
                continue
            i = row_idx[rname]
            sense = senses_by_name[rname]
            bi = b[i]
            if sense == "L":
                lo, hi = bi - abs(rval), bi
            elif sense == "G":
                lo, hi = bi, bi + abs(rval)
            else:  # E
                if rval == 0:
                    continue
                lo, hi = (bi, bi + rval) if rval > 0 else (bi + rval, bi)
                row_senses[rname] = "G"
                b[i] = lo
            extra_sense, extra_rhs = ("G", lo) if sense == "L" else ("L", hi)
            extra_name = rname + "__rng"
            row_order.append(extra_name)
            row_senses[extra_name] = extra_sense
            A = np.concatenate([A, A[i : i + 1]], axis=0)
            b = np.concatenate([b, [extra_rhs]])
        n_rows = len(row_order)

    bound_idx = {}
    name_to_j = {cn: j for j, cn in enumerate(col_order)}
    for cn, lst in bounds.items():
        if cn in name_to_j:
            bound_idx[name_to_j[cn]] = lst

    return LPProblem(
        name=name,
        var_names=col_order,
        row_names=row_order,
        row_senses=[row_senses[r] for r in row_order],
        A=A,
        rhs=b,
        c=c,
        bounds=bound_idx,
    )


def scipy_bounds(prob: LPProblem) -> list:
    """Per-variable (lo, hi) for the solver oracle — standard MPS defaults
    (x >= 0 unless overridden), matching lp_solve's behavior."""
    out = []
    for j in range(prob.n_vars):
        lo, hi = 0.0, None
        for btype, val in prob.bounds.get(j, []):
            if btype == "UP":
                hi = val
                if val < 0 and lo == 0.0:
                    lo = None  # negative upper bound implies free-below
            elif btype == "LO":
                lo = val
            elif btype == "FX":
                lo = hi = val
            elif btype == "FR":
                lo, hi = None, None
            elif btype == "MI":
                lo = None
            elif btype == "PL":
                hi = None
            elif btype == "BV":
                lo, hi = 0.0, 1.0
        out.append((lo, hi))
    return out


def sign_constraints(prob: LPProblem) -> dict:
    """Reference parity: the *checker* only enforces sign constraints for
    explicitly-bounded variables (lpcodegen.py:88-128 RangeConstraint):
      UP with v <= 0  -> x <= 0;  LO with v >= 0 -> x >= 0;
      MI -> x <= 0;   PL -> x >= 0;  inf or anything else -> unconstrained.
    Returns {var_index: '+' | '-'}."""
    out = {}
    for j in range(prob.n_vars):
        for btype, val in prob.bounds.get(j, []):
            if j in out:
                break  # first binding declaration wins (ref: if not bounded)
            if btype == "UP" and val <= 0 and not np.isinf(val):
                out[j] = "-"
            elif btype == "LO" and val >= 0 and not np.isinf(val):
                out[j] = "+"
            elif btype == "MI":
                out[j] = "-"
            elif btype == "PL":
                out[j] = "+"
    return out
