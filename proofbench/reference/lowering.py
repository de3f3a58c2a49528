"""The LP optimality certificate as an R1CS, worked out from the LP alone.

The statement is Otti's LP certificate (lpcodegen): a witness (X, Y) of
fixed-point numbers at scale S = 2^f such that every primal row
sum_j a_ij X_j <= b_i holds within delta, and c.X equals b.Y within delta,
with delta = 0.01 as the configurations state it.  Each comparison is a range check: the slack, an affine
form of the witness, is written in bits, each bit is held Boolean by one
constraint, and one more constraint ties the weighted bits to the slack.
The widths and f follow from the instance and the caps alone (2^22 on
every |X_j| and |Y_i| as stated), never from the witness, so the circuit, its
constraint order and its SHA3-256 digest are fixed by the LP.

Only what the benchmark's LPs use is covered: rows of sense L, no BOUNDS
section (no sign constraints), no public inputs.  Columns follow Spartan's
z layout: witness variables, then, at the padded width, the constant one.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

MOD = 2**252 + 27742317777372353535851937790883648493
DELTA = 0.01
CAP_BITS = 22
MIN_FRAC_BITS = 24


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _width(bound: float) -> int:
    """Bits that hold every honest value in [0, bound]."""
    return int(math.ceil(math.log2(max(bound, 2.0)))) + 1


def frac_bits(A: np.ndarray, b: np.ndarray, c: np.ndarray, delta: float = DELTA,
              cap_bits: int = CAP_BITS) -> int:
    """The smallest f >= 24 at which the rounding of any scaled check stays
    under delta / 8."""
    cap = float(1 << cap_bits)
    caps = np.full(A.shape[1], cap)
    l1 = 1.0
    for i in range(A.shape[0]):
        act = A[i] != 0
        l1 = max(l1, float(np.abs(A[i]).sum() + caps[act].sum()) + abs(b[i]))
    l1 = max(l1, float(np.abs(c).sum() + caps[c != 0].sum()))
    l1 = max(l1, float(np.abs(b).sum()) + cap * max(int((b != 0).sum()), 1))
    return max(MIN_FRAC_BITS, int(math.ceil(math.log2(8.0 * l1 / delta))))


class R1CS:
    """num_cons x (2 num_vars_padded) matrices as {row: [(col, value)]}."""

    def __init__(self, num_vars: int, rows: list):
        self.num_vars = num_vars
        self.num_cons = len(rows)
        self.num_inputs = 0
        self.num_vars_padded = _next_pow2(num_vars)
        self.one = self.num_vars_padded  # the column of the constant one
        self.rows = rows  # [(a_terms, b_terms, c_terms)], terms [(col, value)]

    @property
    def num_cons_padded(self) -> int:
        return _next_pow2(self.num_cons)

    def entries(self, m: int) -> list:
        return sorted((r, col, v) for r, row in enumerate(self.rows) for col, v in row[m])

    def digest(self) -> bytes:
        h = hashlib.sha3_256()
        for n in (self.num_cons, self.num_vars, self.num_inputs):
            h.update(n.to_bytes(8, "little"))
        for tag, m in ((b"A", 0), (b"B", 1), (b"C", 2)):
            ents = self.entries(m)
            h.update(tag + len(ents).to_bytes(8, "little"))
            h.update(b"".join(r.to_bytes(8, "little") + col.to_bytes(8, "little")
                              + v.to_bytes(32, "little") for r, col, v in ents))
        return h.digest()

    def unsatisfied(self, witness: list, inputs: list = ()) -> int:
        """Rows whose <A_r, z> <B_r, z> != <C_r, z> for z = (witness, 0..,
        1, inputs, 0..)."""
        if len(witness) != self.num_vars or len(inputs) != self.num_inputs:
            return self.num_cons
        z = {col: v % MOD for col, v in enumerate(witness)}
        z[self.one] = 1
        z.update({self.one + 1 + i: v % MOD for i, v in enumerate(inputs)})
        bad = 0
        for a, b, c in self.rows:
            za = sum(v * z.get(col, 0) for col, v in a)
            zb = sum(v * z.get(col, 0) for col, v in b)
            zc = sum(v * z.get(col, 0) for col, v in c)
            bad += (za * zb - zc) % MOD != 0
        return bad


def lower(A: np.ndarray, b: np.ndarray, c: np.ndarray, delta: float = DELTA,
          cap_bits: int = CAP_BITS) -> R1CS:
    """The certificate of min c x s.t. A x <= b (every row L) as an R1CS."""
    m, n = A.shape
    f = frac_bits(A, b, c, delta, cap_bits)
    S = 1 << f
    caps = np.full(n, float(1 << cap_bits))
    d_s1 = int(round(delta * S))
    d_s2 = d_s1 * S
    rows: list = []
    nvars = [n + m]  # X_0..X_{n-1}, Y_0..Y_{m-1}, then the bits of each check

    def scaled(v: float) -> int:
        return int(round(float(v) * S))

    def range_check(terms: list, const: int, width: int):
        """terms . z + const in [0, 2^width): width Boolean bits and their sum."""
        base = nvars[0]
        nvars[0] += width
        for k in range(width):
            rows.append(([(base + k, 1)], [(base + k, 1), (ONE, MOD - 1)], []))
        lc = [(col, v % MOD) for col, v in terms if v % MOD]
        if const % MOD:
            lc.append((ONE, const % MOD))
        rows.append(([(base + k, 1 << k) for k in range(width)], [(ONE, 1)], lc))

    ONE = -1  # the constant's column, placed once the width is known
    for i in range(m):
        if not A[i].any():
            continue
        act = A[i] != 0
        bound = float(np.abs(A[i]) @ np.where(act, caps, 0.0)) + abs(b[i]) + delta + 1.0
        terms = [(j, -scaled(A[i, j])) for j in range(n) if A[i, j] != 0.0]
        range_check(terms, scaled(b[i]) * S + d_s2, _width(2.0 * bound * S * S))
    # c.X - b.Y within [-delta, delta]: two one-sided checks
    gap = ([(j, scaled(c[j])) for j in range(n) if c[j] != 0.0]
           + [(n + i, -scaled(b[i])) for i in range(m) if b[i] != 0.0])
    gap = [(col, v) for col, v in gap if v % MOD]
    w_eq = _width(2.0 * d_s2)
    range_check(gap, d_s2, w_eq)
    range_check([(col, -v) for col, v in gap], d_s2, w_eq)
    r1cs = R1CS(nvars[0], [])
    one = r1cs.one
    r1cs.rows = [tuple([(one if col == ONE else col, v) for col, v in t] for t in row)
                 for row in rows]
    r1cs.num_cons = len(rows)
    return r1cs
