# copied from otti_tpu/refimpl/numeric.py
"""Slow, obviously-correct host reference implementations (test oracles).

Pure Python big-int arithmetic for GF(2^255-19) and the ristretto255 scalar
field, plus edwards25519 / ristretto255 group operations per RFC 7748/8032/
9496.  Used to cross-check the batched device kernels, to derive Pedersen
generators on the host, and for tiny host-side verifier steps.

Written from the public RFC specifications — no code is taken from the
reference repo (whose crypto submodules are empty in the snapshot anyway;
SURVEY.md §0.1).
"""

from __future__ import annotations

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # Edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# edwards25519 basepoint (RFC 8032 §5.1)
BASE_Y = (4 * pow(5, P - 2, P)) % P
BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202

# ristretto255 constants (RFC 9496 §4)
SQRT_AD_MINUS_ONE = None  # filled below
INVSQRT_A_MINUS_D = None
ONE_MINUS_D_SQ = None
D_MINUS_ONE_SQ = None


def finv(x: int) -> int:
    return pow(x, P - 2, P)


def is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def sqrt_ratio_m1(u: int, v: int):
    """RFC 9496 §4.2: returns (was_square, sqrt(u/v) or sqrt(i*u/v))."""
    u, v = u % P, v % P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct_sign = check == u % P
    flipped_sign = check == (-u) % P
    flipped_sign_i = check == (-u) % P * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    if is_negative(r):
        r = (-r) % P
    return (correct_sign or flipped_sign), r


def _init_constants():
    global SQRT_AD_MINUS_ONE, INVSQRT_A_MINUS_D, ONE_MINUS_D_SQ, D_MINUS_ONE_SQ
    a = (-1) % P
    _, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (a - D) % P)
    _, SQRT_AD_MINUS_ONE = sqrt_ratio_m1((a * D - 1) % P, 1)
    ONE_MINUS_D_SQ = (1 - D * D) % P
    D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P


_init_constants()


class EdPoint:
    """edwards25519 point in extended homogeneous coordinates (X:Y:Z:T)."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X, Y, Z=1, T=None):
        self.X, self.Y, self.Z = X % P, Y % P, Z % P
        self.T = (X * Y % P * finv(Z)) % P if T is None else T % P

    @staticmethod
    def identity() -> "EdPoint":
        return EdPoint(0, 1, 1, 0)

    @staticmethod
    def base() -> "EdPoint":
        return EdPoint(BASE_X, BASE_Y)

    def __add__(self, o: "EdPoint") -> "EdPoint":
        # add-2008-hwcd-3 for a = -1 (complete, branch-free)
        A = (self.Y - self.X) * (o.Y - o.X) % P
        B = (self.Y + self.X) * (o.Y + o.X) % P
        C = self.T * 2 * D % P * o.T % P
        Dv = self.Z * 2 % P * o.Z % P
        E, F, G, H = (B - A) % P, (Dv - C) % P, (Dv + C) % P, (B + A) % P
        return EdPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def double(self) -> "EdPoint":
        # dbl-2008-hwcd for a = -1
        A = self.X * self.X % P
        B = self.Y * self.Y % P
        C = 2 * self.Z % P * self.Z % P
        H = (A + B) % P
        E = (H - (self.X + self.Y) ** 2) % P
        G = (A - B) % P
        F = (C + G) % P
        return EdPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def __mul__(self, k: int) -> "EdPoint":
        k %= L
        acc, cur = EdPoint.identity(), self
        while k:
            if k & 1:
                acc = acc + cur
            cur = cur.double()
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __neg__(self) -> "EdPoint":
        return EdPoint((-self.X) % P, self.Y, self.Z, (-self.T) % P)

    def affine(self):
        zi = finv(self.Z)
        return self.X * zi % P, self.Y * zi % P

    def __eq__(self, o) -> bool:
        return (
            self.X * o.Z % P == o.X * self.Z % P
            and self.Y * o.Z % P == o.Y * self.Z % P
        )

    def ristretto_eq(self, o: "EdPoint") -> bool:
        """Equality as ristretto255 elements (4-torsion cosets, RFC 9496
        §4.3.3): X1*Y2 == Y1*X2  or  X1*X2 == Y1*Y2 (Z cancels)."""
        return (
            (self.X * o.Y - self.Y * o.X) % P == 0
            or (self.X * o.X - self.Y * o.Y) % P == 0
        )

    # -- ristretto255 ------------------------------------------------------
    def ristretto_encode(self) -> bytes:
        """RFC 9496 §4.3.2 Encode."""
        X, Y, Z, T = self.X, self.Y, self.Z, self.T
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        ix = X * SQRT_M1 % P
        iy = Y * SQRT_M1 % P
        enchanted = den1 * INVSQRT_A_MINUS_D % P
        rotate = is_negative(T * z_inv % P)
        if rotate:
            X, Y = iy, ix
            den_inv = enchanted
        else:
            den_inv = den2
        if is_negative(X * z_inv % P):
            Y = (-Y) % P
        s = den_inv * ((Z - Y) % P) % P
        if is_negative(s):
            s = (-s) % P
        return s.to_bytes(32, "little")

    @staticmethod
    def ristretto_decode(b: bytes) -> "EdPoint | None":
        """RFC 9496 §4.3.1 Decode; None on invalid encoding."""
        if len(b) != 32:
            return None
        s = int.from_bytes(b, "little")
        if s >= P or is_negative(s):
            return None
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(D * u1 % P) * u1 % P - u2_sqr) % P
        was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = 2 * s % P * den_x % P
        if is_negative(x):
            x = (-x) % P
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or is_negative(t) or y == 0:
            return None
        return EdPoint(x, y, 1, t)

    @staticmethod
    def ristretto_map(t: int) -> "EdPoint":
        """RFC 9496 §4.3.4 one-way MAP from a field element."""
        t %= P
        r = SQRT_M1 * t % P * t % P
        u = (r + 1) % P * ONE_MINUS_D_SQ % P
        v = ((-1 - r * D) % P) * ((r + D) % P) % P
        was_square, s = sqrt_ratio_m1(u, v)
        s_prime = s * t % P
        if not is_negative(s_prime):
            s_prime = (-s_prime) % P
        if not was_square:
            s = s_prime
            c = r
        else:
            c = (-1) % P
        N = c * ((r - 1) % P) % P * D_MINUS_ONE_SQ % P - v
        N %= P
        ss = s * s % P
        w0 = 2 * s % P * v % P
        w1 = N * SQRT_AD_MINUS_ONE % P
        w2 = (1 - ss) % P
        w3 = (1 + ss) % P
        return EdPoint(
            w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P
        )

    @staticmethod
    def from_uniform_bytes(b: bytes) -> "EdPoint":
        """RFC 9496 §4.3.4: 64 uniform bytes -> group element (hash-to-group)."""
        assert len(b) == 64
        mask = (1 << 255) - 1
        r0 = int.from_bytes(b[:32], "little") & mask
        r1 = int.from_bytes(b[32:], "little") & mask
        return EdPoint.ristretto_map(r0) + EdPoint.ristretto_map(r1)


def scalar_from_bytes_mod_order_wide(b: bytes) -> int:
    assert len(b) == 64
    return int.from_bytes(b, "little") % L
