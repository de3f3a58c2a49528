"""R1CS instance + device sparse products (port of otti_tpu/spartan/r1cs.py).

``R1CSShape`` is host-only and a copy of the JAX package's class (that
module imports jax); ``to_device(device)`` gives an ``R1CSDevice`` whose
three matrices are COO tensors: int64 row and column indices and
``[nnz, 22]`` int32 values.  Every product is a gather, the multiply
kernel, an exact int64 ``index_add_`` of the canonical products and one
wide reduction.

z layout (Spartan): z = (vars | 1 | inputs | 0-pad), num_vars padded to a
power of two and the io half padded to the same length, so len(z) =
2 * num_vars_padded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random

import numpy as np
import torch

from ..field.fields import N_LIMBS, SCALAR, ints_to_limbs

from ..field import ops as F


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# copied from otti_tpu/spartan/r1cs.py::R1CSShape (to_device is the port's)
@dataclasses.dataclass
class R1CSShape:
    """Host-side canonical R1CS over the ristretto255 scalar field.

    Entries are (row, col, value:int) with col indexing the z layout above:
    cols [0, num_vars) hit witness vars, col num_vars_padded is the constant
    1, cols (num_vars_padded, num_vars_padded+num_inputs] the public inputs.
    Builders use logical col indices (vars then 1 then inputs) and
    ``from_logical`` rewires them to the padded layout."""

    num_cons: int
    num_vars: int
    num_inputs: int
    A: list  # [(row, col, int)]
    B: list
    C: list

    @property
    def num_vars_padded(self) -> int:
        return max(_next_pow2(self.num_vars), _next_pow2(self.num_inputs + 1))

    @property
    def num_cons_padded(self) -> int:
        return _next_pow2(self.num_cons)

    @staticmethod
    def from_logical(num_cons, num_vars, num_inputs, A, B, C) -> "R1CSShape":
        """Build from logical col indices: 0..num_vars-1 = witness vars,
        num_vars = constant one, num_vars+1+i = input i."""
        shape = R1CSShape(num_cons, num_vars, num_inputs, [], [], [])
        npad = shape.num_vars_padded

        def rewire(entries):
            out = []
            for r, c, v in entries:
                v %= SCALAR.modulus
                if v == 0:
                    continue
                if c < num_vars:
                    out.append((r, c, v))
                else:  # constant-1 column or input column
                    out.append((r, npad + (c - num_vars), v))
            return out

        shape.A, shape.B, shape.C = rewire(A), rewire(B), rewire(C)
        return shape

    def digest(self) -> bytes:
        """Canonical SHA3-256 digest binding the instance into transcripts."""
        h = bytearray()
        for tag, mat in ((b"A", self.A), (b"B", self.B), (b"C", self.C)):
            h += tag + len(mat).to_bytes(8, "little")
            for r, c, v in sorted(mat):
                h += r.to_bytes(8, "little") + c.to_bytes(8, "little")
                h += (v % SCALAR.modulus).to_bytes(32, "little")
        meta = (
            self.num_cons.to_bytes(8, "little")
            + self.num_vars.to_bytes(8, "little")
            + self.num_inputs.to_bytes(8, "little")
        )
        return hashlib.sha3_256(bytes(meta + h)).digest()

    def to_device(self, device) -> "R1CSDevice":
        def pack(mat):
            n = len(mat)
            rows = torch.tensor([e[0] for e in mat], dtype=torch.int64)
            cols = torch.tensor([e[1] for e in mat], dtype=torch.int64)
            vals = np.zeros((n, N_LIMBS), np.int32)
            if n:
                vals[:] = ints_to_limbs([e[2] for e in mat])
            return (rows.to(device), cols.to(device), torch.from_numpy(vals).to(device))

        nvp = self.num_vars_padded
        return R1CSDevice(
            num_cons=self.num_cons_padded,
            num_z=2 * nvp,
            num_vars=nvp,
            num_inputs=self.num_inputs,
            mats=tuple(pack(m) for m in (self.A, self.B, self.C)),
            digest=self.digest(),
        )

    def is_satisfied(self, vars_ints, inputs_ints) -> bool:
        m = SCALAR.modulus
        z = list(vars_ints) + [0] * (self.num_vars_padded - self.num_vars)
        z += [1] + list(inputs_ints)
        z += [0] * (2 * self.num_vars_padded - len(z))

        def rowvals(mat):
            acc = [0] * self.num_cons
            for r, c, v in mat:
                acc[r] = (acc[r] + v * z[c]) % m
            return acc

        az, bz, cz = rowvals(self.A), rowvals(self.B), rowvals(self.C)
        return all(a * b % m == c for a, b, c in zip(az, bz, cz))


@dataclasses.dataclass
class R1CSDevice:
    """Device-resident padded R1CS (COO tensors on one device)."""

    num_cons: int  # padded
    num_z: int  # 2 * num_vars_padded
    num_vars: int  # padded
    num_inputs: int
    mats: tuple  # ((rows int64, cols int64, vals [nnz, 22] int32) for A, B, C)
    digest: bytes

    @property
    def device(self) -> torch.device:
        return self.mats[0][2].device

    def _segment_sum(self, prods: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
        acc = torch.zeros((n, N_LIMBS), dtype=torch.int64, device=prods.device)
        acc.index_add_(0, index, prods.to(torch.int64))
        return F.reduce_wide(SCALAR, acc)

    def matvecs(self, z: torch.Tensor) -> tuple:
        """(Az, Bz, Cz): [num_z, 22] -> three [num_cons, 22]."""
        return tuple(
            self._segment_sum(F.mul(SCALAR, vals, z[cols]), rows, self.num_cons)
            for rows, cols, vals in self.mats
        )

    def matvec_T_weighted(self, weights: tuple, e_rx: torch.Tensor) -> torch.Tensor:
        """Phase-2 table M(y) = sum_m w_m sum_{(r, y, v) in M_m} e_rx[r] v;
        weights: 3 limb vectors [22]."""
        acc = None
        for w, (rows, cols, vals) in zip(weights, self.mats):
            prods = F.mul(SCALAR, F.mul(SCALAR, vals, e_rx[rows]), w)
            part = self._segment_sum(prods, cols, self.num_z)
            acc = part if acc is None else F.add(SCALAR, acc, part)
        return acc

    def eval_at(self, e_rx: torch.Tensor, e_ry: torch.Tensor) -> tuple:
        """(A~(rx, ry), B~, C~) from the eq tables of rx and ry."""
        return tuple(
            F.sum_reduce(SCALAR, F.mul(SCALAR, F.mul(SCALAR, vals, e_rx[rows]), e_ry[cols]))
            for rows, cols, vals in self.mats
        )


def assemble_z(vars_limbs: torch.Tensor, inputs_limbs, num_vars_padded: int) -> torch.Tensor:
    """(vars | 1 | inputs | 0) -> [2 * num_vars_padded, 22]."""
    dev = vars_limbs.device
    z = torch.zeros((2 * num_vars_padded, N_LIMBS), dtype=torch.int32, device=dev)
    nv = vars_limbs.shape[0]
    z[:nv] = vars_limbs
    z[num_vars_padded] = F.ones(SCALAR, (), dev)
    if inputs_limbs is not None and inputs_limbs.shape[0]:
        z[num_vars_padded + 1 : num_vars_padded + 1 + inputs_limbs.shape[0]] = inputs_limbs
    return z


# after __graft_entry__._toy_r1cs, on the port's R1CSShape
def random_satisfiable(n_cons: int = 16, n_vars: int = 8, seed: int = 7):
    """Random satisfiable R1CS (A z)(B z) = (C z) with one entry per row in
    each matrix and the constant-one column in C -> (shape, witness)."""
    mod = SCALAR.modulus
    r = random.Random(seed)
    zvars = [r.randrange(mod) for _ in range(n_vars)]
    A, B, C = [], [], []
    for row in range(n_cons):
        ca, cb = r.randrange(n_vars), r.randrange(n_vars)
        va, vb = r.randrange(1, 99), r.randrange(1, 99)
        target = va * zvars[ca] * vb * zvars[cb] % mod
        A.append((row, ca, va))
        B.append((row, cb, vb))
        C.append((row, n_vars, target))
    return R1CSShape.from_logical(n_cons, n_vars, 0, A, B, C), zvars
