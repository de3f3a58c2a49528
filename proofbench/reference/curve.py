"""ristretto255 on edwards25519 in plain Python integers.

Written from RFC 8032 (the curve and its addition laws) and RFC 9496
(ristretto255: decode, encode, equality and the one-way map), for the
reference verifier alone.  A point is a tuple (X, Y, Z, T) of extended
homogeneous coordinates; nothing here is constant-time, since the verifier
handles only public data.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # the group's order
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
D2 = 2 * D % P
IDENTITY = (0, 1, 1, 0)


def _neg_field(x: int) -> bool:
    return x % P & 1 == 1


def sqrt_ratio_m1(u: int, v: int) -> tuple:
    """RFC 9496 4.2: (u/v is a square, the non-negative root of u/v or of
    i*u/v)."""
    u, v = u % P, v % P
    v3 = v * v * v % P
    v7 = v3 * v3 * v % P
    r = u * v3 * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r * r % P
    correct = check == u
    flipped = check == (-u) % P
    flipped_i = check == (-u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    if _neg_field(r):
        r = P - r
    return correct or flipped, r


_, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)
_, SQRT_AD_MINUS_ONE = sqrt_ratio_m1((-D - 1) % P, 1)
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P


def add(p: tuple, q: tuple) -> tuple:
    """Complete addition for a = -1 (RFC 8032 5.1.4)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = T1 * D2 % P * T2 % P
    d = 2 * Z1 * Z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def double(p: tuple) -> tuple:
    X1, Y1, Z1, _ = p
    a = X1 * X1 % P
    b = Y1 * Y1 % P
    c = 2 * Z1 * Z1 % P
    h = a + b
    e = h - (X1 + Y1) * (X1 + Y1)
    g = a - b
    f = c + g
    return e * f % P, g * h % P, f * g % P, e * h % P


def neg(p: tuple) -> tuple:
    X, Y, Z, T = p
    return (-X) % P, Y, Z, (-T) % P


def equal(p: tuple, q: tuple) -> bool:
    """Equality of ristretto255 elements (RFC 9496 4.3.3)."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (X1 * X2 - Y1 * Y2) % P == 0


def decode(b: bytes):
    """RFC 9496 4.3.1; None where ``b`` encodes no element."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or _neg_field(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x * v % P
    x = 2 * s * den_x % P
    if _neg_field(x):
        x = P - x
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _neg_field(t) or y == 0:
        return None
    return x, y, 1, t


def encode(p: tuple) -> bytes:
    """RFC 9496 4.3.2."""
    X, Y, Z, T = p
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 * u2)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 * T % P
    if _neg_field(T * z_inv):
        X, Y = Y * SQRT_M1 % P, X * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        den_inv = den2
    if _neg_field(X * z_inv):
        Y = (-Y) % P
    s = den_inv * (Z - Y) % P
    if _neg_field(s):
        s = P - s
    return s.to_bytes(32, "little")


def _map(t: int) -> tuple:
    """RFC 9496 4.3.4, MAP."""
    t %= P
    r = SQRT_M1 * t * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) * (r + D) % P
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = s * t % P
    if not _neg_field(s_prime):
        s_prime = (-s_prime) % P
    if was_square:
        c = P - 1
    else:
        s, c = s_prime, r
    n = (c * (r - 1) * D_MINUS_ONE_SQ - v) % P
    ss = s * s % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - ss) % P
    w3 = (1 + ss) % P
    return w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P


def from_uniform_bytes(b: bytes) -> tuple:
    """RFC 9496 4.3.4: 64 uniform bytes to an element."""
    mask = (1 << 255) - 1
    return add(_map(int.from_bytes(b[:32], "little") & mask),
               _map(int.from_bytes(b[32:], "little") & mask))


def hash_point(data: bytes) -> tuple:
    """The element of SHAKE256(data) (64 bytes)."""
    return from_uniform_bytes(hashlib.shake_256(data).digest(64))


def msm(points: list, scalars: list) -> tuple:
    """sum_i scalars[i] * points[i]: a shared double-and-add for a few
    points, Pippenger's buckets for many."""
    pairs = [(p, k % L) for p, k in zip(points, scalars, strict=True) if k % L]
    if not pairs:
        return IDENTITY
    if len(pairs) < 16:
        acc = IDENTITY
        for bit in range(max(k for _, k in pairs).bit_length() - 1, -1, -1):
            acc = double(acc)
            for p, k in pairs:
                if k >> bit & 1:
                    acc = add(acc, p)
        return acc
    w = max(4, len(pairs).bit_length() - 3)
    mask = (1 << w) - 1
    acc = IDENTITY
    for shift in range(((L.bit_length() + w - 1) // w - 1) * w, -1, -w):
        for _ in range(w):
            acc = double(acc)
        buckets = [None] * (mask + 1)
        for p, k in pairs:
            j = k >> shift & mask
            if j:
                buckets[j] = p if buckets[j] is None else add(buckets[j], p)
        run, total = IDENTITY, IDENTITY
        for j in range(mask, 0, -1):
            if buckets[j] is not None:
                run = add(run, buckets[j])
            total = add(total, run)
        acc = add(acc, total)
    return acc
