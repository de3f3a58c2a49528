"""ristretto255 point encoding on the device (port of otti_tpu/curve/ristretto.py).

RFC 9496 4.3.2's compression of extended Edwards points, batched, so that
commitment encodings can be absorbed into the device transcript
(transcript/device.py) without a trip to the host.  The reference
algorithm's data-dependent branches (the rotation, the sign fixes) are
selects.

``encode`` is kernel K4: ``encode_cuda`` launches the CUDA kernel of
``csrc/ristretto_encode.cu`` (one thread a point, one launch a batch) on a
CUDA device; ``encode_plain`` is the same function in plain torch on the
field ops (the multiply kernel's plain version on the CPU), and the
reference the kernel is held against on the card.  The inverse square root
in both is the fixed addition chain for the exponent (p - 5) / 8 (251
squarings and 11 multiplies).  The plain version multiplies by the field
ops' convolution and wide reduction, without the multiply kernel, so that
it is a reference independent of kernel 1 as well.

Bit-exact against the JAX package's ``ristretto.encode`` and the host
library's ``ristretto_encode_host`` (tests/test_torch_ristretto.py).
"""

from __future__ import annotations

import torch

from .. import _build
from ..field import ops as F
from ..field.fields import BASE, N_LIMBS
from ..refimpl import numeric as ref
from ..transcript.device import limbs_to_bytes32


def _c(v: int, device) -> torch.Tensor:
    return F.const(BASE, v % ref.P, (), device, cached=True)


def _is_negative(x: torch.Tensor) -> torch.Tensor:
    """Canonical parity bit (RFC 9496 IS_NEGATIVE); x must be canonical."""
    return (x[..., 0] & 1) == 1


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b, semi-reduced, in plain torch: the convolution and the wide
    reduction of the field ops without their final canonicalisation (the
    encoding's value is canonicalised where a sign is read, and at the end)."""
    return F.reduce_product(BASE, F.conv(a, b))


def _pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p - 5) / 8) = z^(2^252 - 3) by ref10's addition chain."""
    def sq_n(a, k):
        for _ in range(k):
            a = _mul(a, a)
        return a

    mul = _mul
    t0 = _mul(z, z)  # z^2
    t1 = mul(z, sq_n(t0, 2))  # z^9
    t0 = mul(t0, t1)  # z^11
    t0 = mul(t1, _mul(t0, t0))  # z^(2^5 - 1)
    t0 = mul(sq_n(t0, 5), t0)  # z^(2^10 - 1)
    t1 = mul(sq_n(t0, 10), t0)  # z^(2^20 - 1)
    t1 = mul(sq_n(t1, 20), t1)  # z^(2^40 - 1)
    t0 = mul(sq_n(t1, 10), t0)  # z^(2^50 - 1)
    t1 = mul(sq_n(t0, 50), t0)  # z^(2^100 - 1)
    t1 = mul(sq_n(t1, 100), t1)  # z^(2^200 - 1)
    t0 = mul(sq_n(t1, 50), t0)  # z^(2^250 - 1)
    return mul(sq_n(t0, 2), z)  # z^(2^252 - 3)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """RFC 9496 4.2 SQRT_RATIO_M1, batched: (was_square mask, the canonical
    nonnegative root of u / v or of i u / v)."""
    dev = u.device
    v3 = _mul(_mul(v, v), v)
    v7 = _mul(_mul(v3, v3), v)
    r = _mul(_mul(u, v3), _pow22523(_mul(u, v7)))
    check = _mul(v, _mul(r, r))
    neg_u = F.neg(BASE, u)
    correct = F.eq(BASE, check, u)
    flipped = F.eq(BASE, check, neg_u)
    flipped_i = F.eq(BASE, check, _mul(neg_u, _c(ref.SQRT_M1, dev)))
    r = F.select(flipped | flipped_i, _mul(r, _c(ref.SQRT_M1, dev)), r)
    r = F.canon(BASE, r)
    r = F.canon(BASE, F.select(_is_negative(r), F.neg(BASE, r), r))
    return correct | flipped, r


def encode_plain(p: dict) -> torch.Tensor:
    """Points {x, y, z, t} of [..., 22] BASE limbs -> uint8 [..., 32], in
    plain torch on the field ops (any device)."""
    X, Y, Z, T = p["x"], p["y"], p["z"], p["t"]
    dev = X.device
    u1 = _mul(F.add(BASE, Z, Y), F.sub(BASE, Z, Y))
    u2 = _mul(X, Y)
    _, invsqrt = sqrt_ratio_m1(F.ones(BASE, u1.shape[:-1], dev),
                               _mul(u1, _mul(u2, u2)))
    den1 = _mul(invsqrt, u1)
    den2 = _mul(invsqrt, u2)
    z_inv = _mul(_mul(den1, den2), T)
    ix = _mul(X, _c(ref.SQRT_M1, dev))
    iy = _mul(Y, _c(ref.SQRT_M1, dev))
    enchanted = _mul(den1, _c(ref.INVSQRT_A_MINUS_D, dev))
    rotate = _is_negative(F.canon(BASE, _mul(T, z_inv)))
    Xr = F.select(rotate, iy, X)
    Yr = F.select(rotate, ix, Y)
    den_inv = F.select(rotate, enchanted, den2)
    y_neg = _is_negative(F.canon(BASE, _mul(Xr, z_inv)))
    Yf = F.select(y_neg, F.neg(BASE, Yr), Yr)
    s = F.canon(BASE, _mul(den_inv, F.sub(BASE, Z, Yf)))
    s = F.canon(BASE, F.select(_is_negative(s), F.neg(BASE, s), s))
    return limbs_to_bytes32(s)


def encode_cuda(p: dict) -> torch.Tensor:
    """The same by the CUDA kernel, one launch (coordinates: int32 [..., 22]
    tensors of one shape on one CUDA device; rows whose values lie in
    [0, 2^256) with |limb| < 2^18, as every semi form does)."""
    X = p["x"]
    shape = X.shape[:-1]
    coords = []
    for k in ("x", "y", "z", "t"):
        c = p[k]
        if c.device.type != "cuda" or c.device != X.device:
            raise ValueError("encode_cuda: the coordinates must share one CUDA device")
        if c.dtype != torch.int32 or c.shape != X.shape or c.shape[-1] != N_LIMBS:
            raise ValueError("encode_cuda: int32 [..., 22] coordinates of one shape required")
        c = c.reshape(-1, N_LIMBS).contiguous()
        if c.data_ptr() % 8:  # rows are read with 8-byte loads
            c = c.clone()
        coords.append(c)
    n = coords[0].shape[0]
    out = torch.empty((n, 32), dtype=torch.uint8, device=X.device)
    if n:
        lib = _build.library()
        err = lib.otti_ristretto_encode(*(c.data_ptr() for c in coords), out.data_ptr(), n,
                                        X.device.index, _build.stream_ptr(X))
        _build.check(err, "ristretto_encode")
        _build.LAUNCHES["ristretto_encode"] += 1
    return out.reshape(shape + (32,))


def encode(p: dict) -> torch.Tensor:
    """Batched extended points -> uint8 [..., 32] encodings: the kernel on a
    CUDA device, the plain version on the CPU."""
    dev = p["x"].device.type
    if dev == "cuda":
        return encode_cuda(p)
    if dev == "cpu":
        return encode_plain(p)
    raise ValueError(f"ristretto.encode: unsupported device {p['x'].device}")
