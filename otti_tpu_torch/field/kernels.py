"""Kernel 1: the batched field multiply (port of otti_tpu/field/pallas_kernels.py).

``mul_cuda`` launches the hand-written CUDA kernel of
``csrc/field_mul.cu``; ``mul_plain`` is the same function in plain torch
(convolution, wide reduction, canonicalisation), used for CPU tensors and
as the reference the kernel is held against on the card.  Both return the
canonical product.  ``mul`` picks by device: a CUDA tensor always goes to
the kernel (or raises), a CPU tensor to the plain version.

``mul_words_model`` is the kernel's arithmetic (``csrc/field.cuh``) on
Python integers, one 32-bit word at a time and step for step, with every
range the CUDA code relies on asserted: the place where a wrong fold shows
without a card.
"""

from __future__ import annotations

import torch

from ..field.fields import N_LIMBS, FieldSpec

from .. import _build
from . import ops as F

FIELD_IDS = {"scalar": 0, "base": 1}


def mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod m, canonical, in plain torch (any device, broadcasting)."""
    return F.canon(spec, F.reduce_wide(spec, F.conv(a, b)))


def mul_cuda(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod m, canonical, by the CUDA kernel.

    a: contiguous int32 [..., 22] on a CUDA device; b: the same shape, or
    one contiguous [22] element shared by every row.  Each row's value
    sum(limb_i * 2^(12 i)) must lie in [0, 2^256) with |limb_i| < 2^18:
    every semi form of ``ops.py`` does (the kernel packs a row into eight
    32-bit words, which hold 2^256 - 1 and nothing more).  Launches on the
    current stream; raises on a launch error."""
    for t in (a, b):
        if t.device.type != "cuda":
            raise ValueError("mul_cuda: tensors must be on a CUDA device")
        if t.dtype != torch.int32:
            raise TypeError(f"mul_cuda: int32 limbs required, got {t.dtype}")
        if t.shape[-1] != N_LIMBS or not t.is_contiguous():
            raise ValueError("mul_cuda: contiguous [..., 22] limb tensors required")
    if a.device != b.device:
        raise ValueError("mul_cuda: a and b on different devices")
    bcast = b.dim() == 1
    if not bcast and b.shape != a.shape:
        raise ValueError(f"mul_cuda: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty_like(a)
    n = a.numel() // N_LIMBS
    if n == 0:
        return out
    lib = _build.library()
    err = lib.otti_field_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, int(bcast),
        FIELD_IDS[spec.kind], _build.stream_ptr(a),
    )
    _build.check(err, "field_mul")
    _build.LAUNCHES["field_mul"] += 1
    return out


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting a * b: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(spec, a, b)
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"mul: unsupported devices {a.device}, {b.device}")
    a, b = a.to(torch.int32), b.to(torch.int32)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if b[..., 0].numel() == 1 < a[..., 0].numel():
        out = mul_cuda(spec, a.contiguous(), b.reshape(N_LIMBS).contiguous())
    elif a[..., 0].numel() == 1 < b[..., 0].numel():
        out = mul_cuda(spec, b.contiguous(), a.reshape(N_LIMBS).contiguous())
    else:
        a, b = torch.broadcast_tensors(a, b)
        out = mul_cuda(spec, a.contiguous(), b.contiguous())
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# The kernel's word-level arithmetic on Python integers (csrc/field.cuh)
# ---------------------------------------------------------------------------

_W = 0xFFFFFFFF


def _m_consts(spec: FieldSpec) -> dict:
    """mod[8], tail[4], fold of this field out of the block the kernels get."""
    block = _build.field_consts().view("uint32").reshape(2, _build.CONST_WORDS)
    row = [int(v) for v in block[FIELD_IDS[spec.kind]]]
    return {"mod": row[:8], "tail": row[8:12], "fold": row[12]}


def _m_value(words) -> int:
    return sum(w << (32 * i) for i, w in enumerate(words))


def _m_add_words(x, y):
    """x += y over len(x) words; returns the carry out (add_words)."""
    c = 0
    for i in range(len(x)):
        c += x[i] + (y[i] if i < len(y) else 0)
        x[i] = c & _W
        c >>= 32
    return c


def _m_sub_words(x, y):
    """x -= y over len(x) words; returns 1 if it went below zero (sub_words)."""
    borrow = 0
    for i in range(len(x)):
        t = (x[i] - (y[i] if i < len(y) else 0) - borrow) & 0xFFFFFFFFFFFFFFFF
        x[i] = t & _W
        borrow = t >> 63
    return borrow


def _m_mul_words(a, b):
    """Schoolbook rows of 32x32->64 multiply-adds (mul_words)."""
    r = [0] * (len(a) + len(b))
    for i in range(len(a)):
        carry = 0
        for j in range(len(b)):
            t = a[i] * b[j] + r[i + j] + carry
            assert t < 1 << 64
            r[i + j] = t & _W
            carry = t >> 32
        r[i + len(b)] = carry
    return r


def _m_shr252(x, n):
    out = []
    for i in range(n):
        lo = x[7 + i] if 7 + i < len(x) else 0
        hi = x[8 + i] if 8 + i < len(x) else 0
        out.append((lo >> 28) | ((hi << 4) & _W))
    return out


def _m_cond_sub(c, x):
    d = list(x)
    return x if _m_sub_words(d, c["mod"]) else d


def _m_scalar_canon9(c, r):
    assert len(r) == 9 and r[8] < 1 << 28
    h = (r[7] >> 28) | ((r[8] << 4) & _W)
    u = _m_mul_words(c["tail"], [h])
    x = r[:8]
    x[7] &= 0x0FFFFFFF
    assert _m_add_words(x, c["mod"]) == 0
    assert _m_sub_words(x, u) == 0
    assert _m_value(x) < 2 * _m_value(c["mod"])
    return _m_cond_sub(c, x)


def _m_base_canon8(c, x):
    x = list(x)
    t = c["tail"][0] * (x[7] >> 31)
    x[7] &= 0x7FFFFFFF
    assert _m_add_words(x, [t]) == 0
    y = list(x)
    assert _m_add_words(y, [c["tail"][0]]) == 0
    ge = y[7] >> 31
    y[7] &= 0x7FFFFFFF
    return y if ge else x


def _m_pack(limbs):
    """fe_pack: 24-bit chunks of two limbs, exact signed carry, words."""
    assert len(limbs) == N_LIMBS and all(abs(v) < 1 << 18 for v in limbs)
    c = [limbs[2 * j] + limbs[2 * j + 1] * 4096 for j in range(11)]
    cr = 0
    for j in range(10):
        v = c[j] + cr
        assert -(1 << 31) <= v < 1 << 31
        c[j] = v & 0xFFFFFF
        cr = v >> 24
    c[10] += cr
    assert 0 <= c[10] < 1 << 16, "fe_pack: value outside [0, 2^256)"
    u = c + [0]
    w = [0] * 8
    for g in range(3):
        q = u[4 * g : 4 * g + 4]
        w[3 * g] = (q[0] | (q[1] << 24)) & _W
        w[3 * g + 1] = ((q[1] >> 8) | (q[2] << 16)) & _W
        if g < 2:
            w[3 * g + 2] = ((q[2] >> 16) | (q[3] << 8)) & _W
    return w


def _m_unpack(w):
    out = []
    for i in range(N_LIMBS):
        bit = 12 * i
        j, off = bit >> 5, bit & 31
        v = w[j] >> off
        if off > 20 and j + 1 < 8:
            v |= (w[j + 1] << (32 - off)) & _W
        out.append(v & 0xFFF)
    return out


def mul_words_model(spec: FieldSpec, a_limbs, b_limbs) -> list:
    """The 22 canonical limbs of a * b mod m, computed as fe_pack, fe_mul
    and fe_unpack of ``csrc/field.cuh`` compute them.  a_limbs, b_limbs:
    22 Python ints each, any semi form with a value in [0, 2^256)."""
    c = _m_consts(spec)
    a, b = _m_pack(list(a_limbs)), _m_pack(list(b_limbs))
    p = _m_mul_words(a, b)
    if spec.kind == "scalar":
        q = _m_mul_words(c["tail"], _m_shr252(p, 9))  # 13 words, < 2^385
        s = _m_mul_words(c["tail"], _m_shr252(q, 5))  # 9 words, < 2^258
        r = p[:8] + [0]
        r[7] &= 0x0FFFFFFF
        assert _m_add_words(r, s) == 0
        assert _m_add_words(r, c["mod"]) == 0
        q0 = q[:8]
        q0[7] &= 0x0FFFFFFF
        assert _m_sub_words(r, q0) == 0
        x = _m_scalar_canon9(c, r)
    else:
        k = c["fold"]
        x, acc = [0] * 8, 0
        for i in range(8):
            acc += k * p[8 + i] + p[i]
            assert acc < 1 << 64
            x[i] = acc & _W
            acc >>= 32
        wrapped = _m_add_words(x, [k * acc])
        x[0] += k * wrapped
        assert x[0] <= _W
        x = _m_base_canon8(c, x)
    assert _m_value(x) < spec.modulus
    return _m_unpack(x)
