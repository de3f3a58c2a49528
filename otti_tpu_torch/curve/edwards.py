"""Batched edwards25519 group ops in extended coordinates (port of
otti_tpu/curve/edwards.py).

A point batch is a dict {"x","y","z","t"} of ``[..., 22]`` int32 limb
tensors over GF(2^255-19).  Formulas: add-2008-hwcd-3 (9M) and
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


def add(p: dict, q: dict) -> dict:
    """Unified extended-coordinate addition (complete; 9 field muls)."""
    d2 = F.const(BASE, D2_INT, (), p["x"].device)
    a = F.mul(BASE, F.sub(BASE, p["y"], p["x"]), F.sub(BASE, q["y"], q["x"]))
    b = F.mul(BASE, F.add(BASE, p["y"], p["x"]), F.add(BASE, q["y"], q["x"]))
    c = F.mul(BASE, F.mul(BASE, p["t"], d2), q["t"])
    d = F.mul(BASE, F.add(BASE, p["z"], p["z"]), q["z"])
    e = F.sub(BASE, b, a)
    f = F.sub(BASE, d, c)
    g = F.add(BASE, d, c)
    h = F.add(BASE, b, a)
    return pt(F.mul(BASE, e, f), F.mul(BASE, g, h), F.mul(BASE, f, g), F.mul(BASE, e, h))


def double(p: dict) -> dict:
    """Extended-coordinate doubling (4M + 4S, a = -1)."""
    a = F.square(BASE, p["x"])
    b = F.square(BASE, p["y"])
    zz = F.square(BASE, p["z"])
    c = F.add(BASE, zz, zz)
    h = F.add(BASE, a, b)
    e = F.sub(BASE, h, F.square(BASE, F.add(BASE, p["x"], p["y"])))
    g = F.sub(BASE, a, b)
    f = F.add(BASE, c, g)
    return pt(F.mul(BASE, e, f), F.mul(BASE, g, h), F.mul(BASE, f, g), F.mul(BASE, e, h))


def select(mask: torch.Tensor, p: dict, q: dict) -> dict:
    """where(mask, p, q) point-wise."""
    return tree_map(lambda a, b: F.select(mask, a, b), p, q)


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
