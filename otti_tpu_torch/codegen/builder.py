# copied from otti_tpu/codegen/builder.py, on the port's R1CSShape
"""Witness-carrying R1CS circuit builder with fixed-point gadgets.

This layer replaces the reference's entire C-codegen + CirC compilation
pipeline (SURVEY.md L4+L3: codegen/*.py emitting C that a Haskell CirC
fork bit-blasts to R1CS, the documented 200GB-RAM bottleneck,
the reference's README.md:39-42).  Because Otti's three certificate
checkers have fixed, known shapes (SURVEY.md §3.1-3.3), we lower each
parsed instance *directly* to R1CS with fixed-point arithmetic gadgets —
the delta-relaxed comparators deq/dge/dle of lpcodegen.py:211-224 and
d_equal of sdpcodegen.py:97-106 become range checks via binary
decomposition, eliminating the FP-bitblast blowup by construction
(SURVEY.md §7.1 "No C front-end" row).

The builder is witness-carrying: every witness variable is created with
its concrete value (supplied by the solver oracle), so constraint
emission and witness generation happen in one pass and the result feeds
straight into the TPU prover.
"""

from __future__ import annotations

import dataclasses

from ..field.fields import SCALAR

from ..spartan.r1cs import R1CSShape

MOD = SCALAR.modulus


def to_field(x: int) -> int:
    return x % MOD


def from_field_signed(x: int) -> int:
    """Canonical field element -> signed integer (small |values| only)."""
    x %= MOD
    return x - MOD if x > MOD // 2 else x


@dataclasses.dataclass(frozen=True)
class LinComb:
    """Sparse linear combination over logical z columns + constant."""

    terms: tuple  # ((col, coeff), ...) with logical col indices
    const: int = 0

    def __add__(self, other):
        if isinstance(other, int):
            return LinComb(self.terms, (self.const + other) % MOD)
        merged = dict(self.terms)
        for c, v in other.terms:
            merged[c] = (merged.get(c, 0) + v) % MOD
        return LinComb(
            tuple((c, v) for c, v in merged.items() if v),
            (self.const + other.const) % MOD,
        )

    def __sub__(self, other):
        return self + (other * (MOD - 1) if isinstance(other, LinComb) else -other)

    def __mul__(self, k: int):
        k %= MOD
        return LinComb(
            tuple((c, v * k % MOD) for c, v in self.terms), self.const * k % MOD
        )

    __rmul__ = __mul__
    __radd__ = __add__


ZERO = LinComb(())
ONE = LinComb((), 1)


class Builder:
    def __init__(self, name: str = ""):
        self.name = name
        self.var_values: list = []  # witness values (ints)
        self.input_values: list = []  # public input values (ints)
        self._raw: list = []  # (row, a, b, c) pending constraints
        self._n_cons = 0

    # -- variable creation -------------------------------------------------
    def var(self, value: int) -> LinComb:
        idx = len(self.var_values)
        self.var_values.append(to_field(value))
        return LinComb(((idx, 1),))

    def public_input(self, value: int) -> LinComb:
        idx = len(self.input_values)
        self.input_values.append(to_field(value))
        # logical col: num_vars + 1 + idx, resolved at finalize
        return LinComb(((("in", idx), 1),))

    # -- low-level constraint ---------------------------------------------
    def _resolve(self, lc: LinComb, num_vars: int):
        out = []
        for c, v in lc.terms:
            if isinstance(c, tuple):  # ("in", idx)
                out.append((num_vars + 1 + c[1], v))
            else:
                out.append((c, v))
        if lc.const:
            out.append((num_vars, lc.const))
        return out

    def constrain(self, a: LinComb, b: LinComb, c: LinComb):
        """Add constraint <a,z> * <b,z> = <c,z>."""
        row = self._n_cons
        self._n_cons += 1
        self._raw.append((row, a, b, c))

    # -- evaluation of a LinComb under current assignment ------------------
    def value_of(self, lc: LinComb) -> int:
        acc = lc.const
        for c, v in lc.terms:
            if isinstance(c, tuple):
                acc += v * self.input_values[c[1]]
            else:
                acc += v * self.var_values[c]
        return acc % MOD

    # -- gadgets -----------------------------------------------------------
    def mul(self, a: LinComb, b: LinComb) -> LinComb:
        out = self.var(self.value_of(a) * self.value_of(b))
        self.constrain(a, b, out)
        return out

    def assert_eq(self, a: LinComb, b: LinComb):
        self.constrain(a, ONE, b)

    def assert_bool(self, v: LinComb):
        self.constrain(v, v - ONE, ZERO)

    def bits(self, lc: LinComb, n_bits: int) -> list:
        """Decompose value(lc) into n_bits booleans; asserts equality.

        Acts as the range check value(lc) in [0, 2^n_bits) — the core
        gadget behind every delta comparison.
        """
        val = self.value_of(lc)
        assert val < (1 << n_bits), (
            f"range check would fail: {val} needs more than {n_bits} bits "
            f"(circuit {self.name})"
        )
        # bulk emission: extend the witness in one go and build the weighted
        # sum as ONE LinComb (the incremental acc+b*2^i chain is O(n_bits^2)
        # in tuple copies and dominated full-suite lowering, VERDICT r02 #8)
        base = len(self.var_values)
        self.var_values.extend((val >> i) & 1 for i in range(n_bits))
        bs = [LinComb(((base + i, 1),)) for i in range(n_bits)]
        for b in bs:
            self.assert_bool(b)
        acc = LinComb(tuple((base + i, 1 << i) for i in range(n_bits)))
        self.assert_eq(acc, lc)
        return bs

    def assert_nonneg(self, lc: LinComb, n_bits: int):
        self.bits(lc, n_bits)

    def assert_ge(self, a: LinComb, b: LinComb, n_bits: int):
        """a >= b over signed-bounded values."""
        self.assert_nonneg(a - b, n_bits)

    def assert_in_pm(self, lc: LinComb, bound: int, n_bits: int):
        """-bound <= value <= bound (the deq comparator's core)."""
        self.assert_nonneg(lc + bound, n_bits)
        self.assert_nonneg(LinComb((), to_field(bound)) - lc, n_bits)

    # -- fixed-point delta comparators (lpcodegen.py:211-224 semantics) ----
    def deq(self, a: LinComb, b: LinComb, delta_scaled: int, n_bits: int):
        self.assert_in_pm(a - b, delta_scaled, n_bits)

    def dge(self, a: LinComb, b: LinComb, delta_scaled: int, n_bits: int):
        self.assert_nonneg(a + delta_scaled - b, n_bits)

    def dle(self, a: LinComb, b: LinComb, delta_scaled: int, n_bits: int):
        self.assert_nonneg(b + delta_scaled - a, n_bits)

    # -- finalize ----------------------------------------------------------
    def finalize(self) -> tuple:
        """-> (R1CSShape, vars_ints, inputs_ints)."""
        num_vars = len(self.var_values)
        A, B, C = [], [], []
        for row, a, b, c in self._raw:
            A += [(row, col, v) for col, v in self._resolve(a, num_vars)]
            B += [(row, col, v) for col, v in self._resolve(b, num_vars)]
            C += [(row, col, v) for col, v in self._resolve(c, num_vars)]
        shape = R1CSShape.from_logical(
            self._n_cons, num_vars, len(self.input_values), A, B, C
        )
        return shape, list(self.var_values), list(self.input_values)

    def sanity_check(self) -> bool:
        """Evaluate every constraint under the current assignment (host)."""
        for _, a, b, c in self._raw:
            if self.value_of(a) * self.value_of(b) % MOD != self.value_of(c):
                return False
        return True
