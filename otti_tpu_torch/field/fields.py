# copied from otti_tpu/field/fields.py
"""Prime-field constants and host codecs of the proving stack.

Two fields are needed (Spartan works over the curve25519/ristretto255
group):

  * ``SCALAR`` -- the ristretto255 scalar field, ell = 2^252 + 27742...493.
    All R1CS/sumcheck/polynomial arithmetic lives here.
  * ``BASE``   -- GF(2^255 - 19), the Edwards-curve coordinate field.

Representation
--------------
A field element is a vector of ``N_LIMBS = 22`` little-endian limbs of
``LIMB_BITS = 12`` bits each (264 bits total), stored as ``int32``.  A full
schoolbook limb convolution of two *normalized* inputs stays inside signed
int32:

    22 limbs * (2^12)^2 per product term  ->  max coeff < 22 * 2^24 < 2^29.

This is the storage layout of every tensor of the package and the layout
the plain torch arithmetic of ``field/ops.py`` computes in; the CUDA
kernels repack it into 32-bit words in registers.

Reduction strategy of the plain arithmetic (no Montgomery needed):
  1. ``conv``      -- 43-coeff limb convolution.
  2. ``carry``     -- normalize to 12-bit limbs (+1 overflow limb).
  3. matrix fold   -- limbs >= 21 (bits >= 252) are folded down with a
                     precomputed int32 matrix R[j] = limbs(2^(12*(21+j)) mod m).
  4. final fold    -- modulus-specific: split at the modulus' power-of-two
                     boundary and add/subtract the small tail constant
                     (19 for BASE, the 125-bit c for SCALAR).

Elements are kept *semi-reduced* (< 2^253 for SCALAR, < 2^256 for BASE) and
only canonicalized (< m) for encoding/equality -- one or two conditional
subtracts.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np

LIMB_BITS = 12
N_LIMBS = 22
LIMB_MASK = (1 << LIMB_BITS) - 1
CONV_LIMBS = 2 * N_LIMBS - 1  # 43
# limb index at which bit 252 starts (21 * 12 == 252)
FOLD_LIMB = 21

# ---------------------------------------------------------------------------
# Moduli
# ---------------------------------------------------------------------------
P25519 = 2**255 - 19
# group order of curve25519 / ristretto255
L25519 = 2**252 + 27742317777372353535851937790883648493
SCALAR_TAIL = L25519 - 2**252  # the 125-bit constant c with ell = 2^252 + c


def int_to_limbs(x: int, n: int = N_LIMBS) -> np.ndarray:
    """Python int -> little-endian 12-bit limb vector (host codec)."""
    assert x >= 0
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    assert x == 0, "value does not fit in limbs"
    return out


def limbs_to_int(limbs) -> int:
    """Little-endian limb vector (any per-limb magnitude) -> Python int."""
    acc = 0
    for i, v in enumerate(np.asarray(limbs).tolist()):
        acc += int(v) << (LIMB_BITS * i)
    return acc


def ints_to_limbs(xs: Sequence[int], n: int = N_LIMBS) -> np.ndarray:
    """Batch host codec.  For the standard 22-limb layout the conversion is
    vectorized: each int is serialized once (C-speed ``int.to_bytes``) and
    the 12-bit limbs are carved out of the byte matrix with numpy ops —
    ~30x faster than per-limb Python shifts on full-suite R1CS sizes."""
    if n == N_LIMBS and len(xs) > 16:
        nbytes = 3 * (N_LIMBS // 2)  # 33 bytes = 264 bits = 22 limbs
        try:
            raw = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
        except OverflowError:
            return np.stack([int_to_limbs(int(x), n) for x in xs], axis=0)
        b = np.frombuffer(raw, np.uint8).reshape(-1, nbytes)
        b0 = b[:, 0::3].astype(np.int32)
        b1 = b[:, 1::3].astype(np.int32)
        b2 = b[:, 2::3].astype(np.int32)
        out = np.empty((b.shape[0], N_LIMBS), np.int32)
        out[:, 0::2] = b0 | ((b1 & 0xF) << 8)
        out[:, 1::2] = (b1 >> 4) | (b2 << 4)
        return out
    return np.stack([int_to_limbs(int(x), n) for x in xs], axis=0)


def limbs_to_ints(arr) -> list:
    a = np.asarray(arr)
    flat = a.reshape(-1, a.shape[-1])
    return [limbs_to_int(row) for row in flat]


class FieldSpec:
    """Host-side constants for one prime field (consumed by field.ops)."""

    def __init__(self, name: str, modulus: int):
        self.name = name
        self.modulus = modulus
        self.modulus_limbs = int_to_limbs(modulus)
        # Fold matrix: row j = limbs of (2^(12*(FOLD_LIMB+j)) mod m) for the
        # high limbs of a carried 44-limb convolution result.
        n_high = (CONV_LIMBS + 1) - FOLD_LIMB  # 23 rows
        rows = []
        for j in range(n_high):
            rows.append(int_to_limbs(pow(2, LIMB_BITS * (FOLD_LIMB + j), modulus)))
        self.fold_matrix = np.stack(rows, axis=0).astype(np.int32)  # [23, 22]
        if modulus == L25519:
            self.kind = "scalar"
            # ell = 2^252 + c  =>  2^252 == -c (mod ell)
            self.tail = SCALAR_TAIL
            self.tail_limbs = int_to_limbs(self.tail, 11)  # 125 bits -> 11 limbs
            self.semi_bound_bits = 253
        elif modulus == P25519:
            self.kind = "base"
            # p = 2^255 - 19  =>  2^255 == 19 (mod p)
            self.tail = 19
            self.semi_bound_bits = 256
        else:
            raise ValueError("unsupported modulus")

    def __repr__(self):  # pragma: no cover
        return f"FieldSpec({self.name})"


SCALAR = FieldSpec("scalar25519", L25519)
BASE = FieldSpec("base25519", P25519)


@functools.lru_cache(maxsize=None)
def _pow_bits(exponent: int) -> tuple:
    """MSB-first bit tuple of a fixed exponent (for unrolled pow chains)."""
    return tuple(int(b) for b in bin(exponent)[2:])
