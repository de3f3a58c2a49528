"""Batched edwards25519 group ops in extended coordinates (port of
otti_tpu/curve/edwards.py).

A point batch is a dict {"x","y","z","t"} of ``[..., 22]`` int32 limb
tensors over GF(2^255-19), each coordinate canonical (``add`` and
``double`` rely on it).  Formulas: add-2008-hwcd-3 (9M) and
dbl-2008-hwcd (4M+4S), complete on the prime-order ristretto subgroup, so
every point of a batch follows the same instruction stream.  The field
multiplies go to the multiply kernel on a CUDA device.
"""

from __future__ import annotations

import torch

from ..field.fields import BASE, LIMB_BITS, N_LIMBS, SCALAR
from ..refimpl import numeric as ref

from ..field import ops as F

D2_INT = (2 * ref.D) % ref.P
COORDS = ("x", "y", "z", "t")


def pt(x, y, z, t) -> dict:
    return {"x": x, "y": y, "z": z, "t": t}


def tree_map(fn, *ps) -> dict:
    return {k: fn(*(p[k] for p in ps)) for k in COORDS}


def identity(shape=(), device="cpu") -> dict:
    zero = F.zeros(shape, device)
    one = F.ones(BASE, shape, device).contiguous()
    return pt(zero, one, one.clone(), zero.clone())


def base_point(shape=(), device="cpu") -> dict:
    return from_affine_ints(ref.BASE_X, ref.BASE_Y, shape, device)


def from_affine_ints(x: int, y: int, shape=(), device="cpu") -> dict:
    """The point (x, y) (canonical ints) in extended coordinates, broadcast
    to ``shape``."""
    return pt(*(F.const(BASE, v, shape, device).contiguous()
                for v in (x, y, 1, x * y % ref.P)))


_P_LIMBS: dict = {}


def _p_limbs(device) -> torch.Tensor:
    """The canonical limbs of p (int32 [22]), uploaded once per device."""
    key = str(device)
    t = _P_LIMBS.get(key)
    if t is None:
        t = _P_LIMBS[key] = torch.tensor(BASE.modulus_limbs, dtype=torch.int32, device=device)
    return t


def add(p: dict, q: dict) -> dict:
    """Unified extended-coordinate addition (complete; 9 field muls, in three
    batched multiply launches: the four independent products of the inputs,
    the one by 2d, then the four of the result).

    Every coordinate this module makes is canonical (each is a product of
    the multiply, or a constant), so the sums and differences that only
    feed a multiply are taken lazily, as plain limb arithmetic: a + b and
    a - b + p of canonical a, b lie in [0, 2p) with limbs in (-2^12, 2^13),
    which the multiply takes as it is (any row below 2^256 whose limbs stay
    under 2^18; the plain version's reduction allows 2^13)."""
    d2 = F.const(BASE, D2_INT, (), p["x"].device, cached=True)
    pl = _p_limbs(p["x"].device)
    shape = torch.broadcast_shapes(p["x"].shape, q["x"].shape)
    p, q = (tree_map(lambda a: a.expand(shape), r) for r in (p, q))
    ys, xs = torch.stack([p["y"], q["y"]]), torch.stack([p["x"], q["x"]])
    s, u = ys + pl - xs, ys + xs  # y - x and y + x of both points
    a, b, tt, d = F.mul(BASE, torch.stack([s[0], u[0], p["t"], p["z"] + p["z"]]),
                        torch.stack([s[1], u[1], q["t"], q["z"]]))
    c = F.mul(BASE, tt, d2)
    e, f = torch.stack([b, d]) + pl - torch.stack([a, c])  # b - a, d - c
    g, h = torch.stack([d, b]) + torch.stack([c, a])  # d + c, b + a
    return pt(*F.mul(BASE, torch.stack([e, g, f, e]), torch.stack([f, h, g, h])))


def double(p: dict) -> dict:
    """Extended-coordinate doubling (dbl-2008-hwcd, a = -1), in two batched
    multiply launches: x^2, y^2, 2 z^2 and x y, then the four products.
    Sums and differences lazily, as in ``add``; f = 2 z^2 + x^2 - y^2 is
    the one that needs a reduction (it may reach 3p)."""
    pl = _p_limbs(p["x"].device)
    x, y, z = p["x"], p["y"], p["z"]
    a, b, c, xy = F.mul(BASE, torch.stack([x, y, z, x]), torch.stack([x, y, z + z, y]))
    h = a + b
    g = a + pl - b  # a - b
    e = (pl - xy) * 2  # -2 x y, in (0, 2p]
    f = F.add(BASE, c, g)
    return pt(*F.mul(BASE, torch.stack([e, g, f, e]), torch.stack([f, h, g, h])))


def negate(p: dict) -> dict:
    """-p, with canonical coordinates as every point of this module has."""
    return pt(F.canon(BASE, F.neg(BASE, p["x"])), p["y"], p["z"],
              F.canon(BASE, F.neg(BASE, p["t"])))


def select(mask: torch.Tensor, p: dict, q: dict) -> dict:
    """where(mask, p, q) point-wise."""
    return tree_map(lambda a, b: F.select(mask, a, b), p, q)


def cadd(mask: torch.Tensor, p: dict, q: dict) -> dict:
    """p + q where mask, else p (the same launches either way)."""
    return select(mask, add(p, q), p)


def eq(p: dict, q: dict) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    ex = F.eq(BASE, F.mul(BASE, p["x"], q["z"]), F.mul(BASE, q["x"], p["z"]))
    ey = F.eq(BASE, F.mul(BASE, p["y"], q["z"]), F.mul(BASE, q["y"], p["z"]))
    return ex & ey


def scalar_mul_bits(p: dict, bits: torch.Tensor) -> dict:
    """p * k for ``bits`` [..., n_bits] LSB first, as a double-and-always-add
    ladder: every bit costs one double and one add whatever its value, and
    the bits stay on the device (a select, not a branch on the host)."""
    acc = identity(tuple(bits.shape[:-1]), bits.device)
    cur = p
    n_bits = bits.shape[-1]
    for i in range(n_bits):
        acc = cadd(bits[..., i] == 1, acc, cur)
        if i + 1 < n_bits:  # the last doubling would go unused
            cur = double(cur)
    return acc


def scalar_mul(p: dict, k_limbs: torch.Tensor) -> dict:
    """p * k for SCALAR limbs k (any semi form: the bits are those of the
    canonical value, 253 of them)."""
    return scalar_mul_bits(p, scalars_to_bits(k_limbs, 253))


def stack(points: list) -> dict:
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *points)


def sum_points(p: dict, axis: int = 0) -> dict:
    """Tree-reduce a batch of points along ``axis``: n - 1 adds in
    ceil(log2(n)) batched levels.  Where n is no power of two (a blinded Hyrax
    row sums (cols + 1) * 32 points), the points beyond the largest power of
    two P below n are first added onto the first n - P, and the tree runs
    over P: nothing is padded, and every level but that first has a
    power-of-two width.  The sum does not depend on how the tree is cut."""
    p = tree_map(lambda a: torch.movedim(a, axis, 0), p)
    n = p["x"].shape[0]
    if n == 0:
        return identity(tuple(p["x"].shape[1:-1]), p["x"].device)
    half = 1 << (n.bit_length() - 1)
    if n > half:
        extra = n - half
        s = add(tree_map(lambda a: a[:extra], p), tree_map(lambda a: a[half:], p))
        p = tree_map(lambda a, b: torch.cat([a, b[extra:half]], dim=0), s, p)
    while half > 1:
        half //= 2
        p = add(tree_map(lambda a: a[:half], p), tree_map(lambda a: a[half : 2 * half], p))
    return tree_map(lambda a: a[0], p)


def scalars_to_bits(scalars: torch.Tensor, n_bits: int = 256) -> torch.Tensor:
    """SCALAR-field limbs [..., 22] -> [..., n_bits] bits (LSB first) of the
    canonical value."""
    s = F.canon(SCALAR, scalars).to(torch.int64)
    pos = torch.arange(n_bits, device=s.device)
    limb = torch.clamp(pos // LIMB_BITS, max=N_LIMBS - 1)
    bits = (s[..., limb] >> (pos % LIMB_BITS)) & 1
    return torch.where(pos // LIMB_BITS < N_LIMBS, bits, torch.zeros_like(bits))


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverses of BASE elements [n, 22] (``field.ops.inv``: 0 -> 0)."""
    return F.inv(BASE, x)


def to_affine_pack(p: dict) -> torch.Tensor:
    """Points [n] -> packed affine [n, 16] int32 (x | y as 32-bit words, the
    bits of the JAX package's uint32 layout), z normalised to 1."""
    zinv = batch_inv(p["z"])
    xa = F.canon(BASE, F.mul(BASE, p["x"], zinv))
    ya = F.canon(BASE, F.mul(BASE, p["y"], zinv))
    return F.words_to_i32(torch.cat([F.pack_words(xa), F.pack_words(ya)], dim=-1))


def from_affine_pack(packed: torch.Tensor) -> dict:
    """Packed affine [..., 16] -> extended point (z = 1, t = x * y)."""
    x = F.unpack_words(packed[..., :8])
    y = F.unpack_words(packed[..., 8:])
    z = F.ones(BASE, x.shape[:-1], x.device).contiguous()
    return pt(x, y, z, F.mul(BASE, x, y))


def from_ref(q: ref.EdPoint, shape=(), device="cpu") -> dict:
    return pt(*(F.const(BASE, v, shape, device).contiguous() for v in (q.X, q.Y, q.Z, q.T)))


def to_ref(p: dict) -> ref.EdPoint:
    """A single (unbatched) point -> host reference point."""
    return ref.EdPoint(*(F.to_int(BASE, p[k]) for k in COORDS))


def to_refs(p: dict) -> list:
    """A flat batch [n] -> host reference points (one fetch per coordinate)."""
    cols = [F.to_ints(BASE, p[k]) for k in COORDS]
    return [ref.EdPoint(*vals) for vals in zip(*cols)]
