"""Batched field arithmetic on torch limb tensors (port of otti_tpu/field/ops.py).

A field element is ``[..., 22]`` int32: 22 little-endian 12-bit limbs in
"semi" form (value < 2^253 for SCALAR, < 2^256 for BASE; limbs near
[0, 2^12), a limb may be -1 after a subtraction), exactly the layout of the
JAX package, so the two can be compared element for element.  ``canon``
gives the unique representative in [0, m).

Everything here is plain torch and runs on any device, except ``mul``: it
is the hand-written CUDA kernel on a CUDA tensor and its plain version on a
CPU tensor (``field/kernels.py``).  Intermediates are int64, because torch
on the CPU has no uint32 ``+`` or ``>>``; the int64 headroom also makes the
carries exact for any sum of up to 2^40 canonical elements.

The TPU-only int8-MXU forms of the JAX package (``mul_scalar``,
``dot_mxu``) have no counterpart: a shared scalar is the multiply kernel
with a broadcast operand, and an inner product is that kernel and a sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.fields import (  # noqa: F401  (SCALAR, BASE re-exported)
    BASE,
    CONV_LIMBS,
    FOLD_LIMB,
    LIMB_BITS,
    LIMB_MASK,
    N_LIMBS,
    SCALAR,
    FieldSpec,
    int_to_limbs,
    ints_to_limbs,
)

I32 = torch.int32
I64 = torch.int64


def _consts(spec: FieldSpec, device) -> dict:
    """Per-(field, device) constant tensors (int64)."""
    key = (spec.name, str(device))
    c = _CONST_CACHE.get(key)
    if c is None:
        c = {
            "m": torch.tensor(spec.modulus_limbs, dtype=I64, device=device),
            "two_m": torch.tensor(
                int_to_limbs(2 * spec.modulus, N_LIMBS), dtype=I64, device=device
            ),
            "fold": torch.tensor(spec.fold_matrix, dtype=I64, device=device),
        }
        c["m_words"] = _to_words(c["m"])
        if spec.kind == "scalar":
            c["tail"] = torch.tensor(spec.tail_limbs, dtype=I64, device=device)
        _CONST_CACHE[key] = c
    return c


_CONST_CACHE: dict = {}


# ---------------------------------------------------------------------------
# Limb-level primitives (int64 in, int64 out)
# ---------------------------------------------------------------------------

def _fit(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Zero-pad to n_out limbs, or fold limbs >= n_out into the top limb."""
    n_in = x.shape[-1]
    if n_in < n_out:
        pad = x.new_zeros(x.shape[:-1] + (n_out - n_in,))
        return torch.cat([x, pad], dim=-1)
    if n_in > n_out:
        top = x[..., n_out - 1].clone()
        for j in range(n_out, n_in):
            top += x[..., j] << (LIMB_BITS * (j - (n_out - 1)))
        return torch.cat([x[..., : n_out - 1], top[..., None]], dim=-1)
    return x


_WORD_LIMBS = 4  # canon carries exactly on 48-bit words of 4 limbs
_WORD_BITS = _WORD_LIMBS * LIMB_BITS


def _to_words(x: torch.Tensor) -> torch.Tensor:
    """[..., n] int64 limbs (|limb| < 2^25) -> [..., ceil(n/4)] int64 words
    of the same value (word w = sum of limbs 4w..4w+3, shifted)."""
    pad = (-x.shape[-1]) % _WORD_LIMBS
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    x = x.reshape(x.shape[:-1] + (-1, _WORD_LIMBS))
    shifts = torch.arange(0, _WORD_BITS, LIMB_BITS, device=x.device)
    return (x << shifts).sum(-1)


def _carry_words(w: torch.Tensor) -> torch.Tensor:
    """Exact signed carry across words: all but the top in [0, 2^48)."""
    words = list(w.unbind(-1))
    for i in range(len(words) - 1):
        words[i + 1] = words[i + 1] + (words[i] >> _WORD_BITS)
        words[i] = words[i] & ((1 << _WORD_BITS) - 1)
    return torch.stack(words, dim=-1)


def _from_words(w: torch.Tensor, n_out: int) -> torch.Tensor:
    """Carried words -> n_out limbs, the top limb unmasked (keeps the rest)."""
    shifts = torch.arange(0, _WORD_BITS, LIMB_BITS, device=w.device)
    limbs = ((w[..., None] >> shifts) & LIMB_MASK).flatten(-2)[..., :n_out].clone()
    top = n_out - 1
    limbs[..., top] = w[..., top // _WORD_LIMBS] >> (LIMB_BITS * (top % _WORD_LIMBS))
    return limbs


def carry(x: torch.Tensor, n_out: int, passes: int = 4) -> torch.Tensor:
    """Flat partial carry: each pass moves every limb's signed residual one
    limb up (the top limb is never split).  Each pass cuts the residuals by
    12 bits, so ``passes`` >= ceil((bits - 12) / 12) + 2 brings limbs of
    magnitude < 2^bits to within a few units of [0, 2^12)."""
    x = _fit(x.to(I64), n_out)
    for _ in range(passes):
        lo = x & LIMB_MASK
        hi = x >> LIMB_BITS
        x = torch.cat([lo[..., :-1], x[..., -1:]], dim=-1)
        x[..., 1:] += hi[..., :-1]
    return x


def conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook limb convolution [..., 22] x [..., 22] -> [..., 43] (int64)."""
    a, b = torch.broadcast_tensors(a.to(I64), b.to(I64))
    out = a.new_zeros(a.shape[:-1] + (CONV_LIMBS,))
    for i in range(N_LIMBS):
        out[..., i : i + N_LIMBS] += a[..., i : i + 1] * b
    return out


def _fold_high(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Fold limbs >= 21 of a carried value through the fold matrix, -> 23
    limbs (a broadcast multiply and sum: CUDA has no int64 matmul)."""
    high = x[..., FOLD_LIMB:]
    fold = _consts(spec, x.device)["fold"][: high.shape[-1]]
    out = _fit(x[..., :FOLD_LIMB], N_LIMBS) + (high[..., :, None] * fold).sum(-2)
    return carry(out, FOLD_LIMB + 2, passes=4)


def _fold_final(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Modulus-specific fold of a <= 23-limb value below 2^379 (so that
    c * (x >> 252) < m) -> semi form.

    SCALAR: V = m + (x mod 2^252) - c * (x >> 252), in (0, 2m).
    BASE:   V = (x mod 2^255) + 19 * (x >> 255)."""
    x = _fit(x, FOLD_LIMB + 2)
    c = _consts(spec, x.device)
    if spec.kind == "scalar":
        h0 = x[..., FOLD_LIMB : FOLD_LIMB + 1]
        h1 = x[..., FOLD_LIMB + 1 : FOLD_LIMB + 2]
        out = c["m"] + _fit(x[..., :FOLD_LIMB], N_LIMBS)
        out[..., 0:11] -= h0 * c["tail"]
        out[..., 1:12] -= h1 * c["tail"]
        return carry(out, N_LIMBS)
    h = (x[..., FOLD_LIMB] >> 3) + (x[..., FOLD_LIMB + 1] << 9)
    out = _fit(x[..., :FOLD_LIMB], N_LIMBS).clone()
    out[..., FOLD_LIMB] = x[..., FOLD_LIMB] & 7
    out[..., 0] += 19 * h
    return carry(out, N_LIMBS)


def reduce_wide(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Reduce a wide limb vector (width <= 43, limbs of magnitude < 2^48,
    value >= 0) to semi form (int32)."""
    assert x.shape[-1] <= CONV_LIMBS, "reduce_wide: input too wide"
    n = max(x.shape[-1], FOLD_LIMB + 2)
    x = carry(x, n + 1, passes=6)
    if x.shape[-1] > FOLD_LIMB + 2:
        x = _fold_high(spec, x)
    return _fold_final(spec, x).to(I32)


# ---------------------------------------------------------------------------
# Field API (semi form in, semi form out, int32)
# ---------------------------------------------------------------------------

def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (N_LIMBS,), dtype=I32, device=device)


def const(spec: FieldSpec, value: int, shape=(), device="cpu") -> torch.Tensor:
    limbs = torch.tensor(int_to_limbs(value % spec.modulus), dtype=I32, device=device)
    return limbs.expand(tuple(shape) + (N_LIMBS,))


def ones(spec: FieldSpec, shape=(), device="cpu") -> torch.Tensor:
    return const(spec, 1, shape, device)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fold_final(spec, carry(a.to(I64) + b, N_LIMBS + 1, passes=2)).to(I32)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    two_m = _consts(spec, a.device)["two_m"]
    return _fold_final(spec, carry(a.to(I64) + two_m - b, N_LIMBS + 1, passes=2)).to(I32)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b, canonical: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see field/kernels.py)."""
    return _kernels.mul(spec, a, b)


def square(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mul(spec, a, a)


def mul_small(spec: FieldSpec, a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small non-negative python int (k < 2^24)."""
    assert 0 <= k < (1 << 24)
    return reduce_wide(spec, a.to(I64) * k)


def canon(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, m) of a semi value (< 3m): an exact
    carry and two conditional subtractions of m, on 48-bit words."""
    m = _consts(spec, x.device)["m_words"]
    w = _carry_words(_to_words(_fit(x.to(I64), N_LIMBS)))
    for _ in range(2):
        d = _carry_words(w - m)
        w = torch.where((d[..., -1] >= 0)[..., None], d, w)
    return _from_words(w, N_LIMBS).to(I32)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with mask shaped [...] over limb vectors [..., 22]."""
    return torch.where(mask[..., None], a, b)


def sum_reduce(spec: FieldSpec, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Field sum along ``axis``: one int64 limb sum (exact for < 2^30
    terms), then one modular reduction."""
    return reduce_wide(spec, x.to(I64).sum(dim=axis))


def dot(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inner product sum_i a_i * b_i along ``axis``: the multiply kernel,
    then a sum."""
    return sum_reduce(spec, mul(spec, a, b), axis=axis)


# ---------------------------------------------------------------------------
# Packed 8-word codec (32 B per canonical element), words held as int64
# in [0, 2^32)
# ---------------------------------------------------------------------------

PACK_WORDS = 8


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """CANONICAL limbs [..., 22] -> [..., 8] little-endian 32-bit words."""
    x = x.to(I64)
    words = []
    for w in range(PACK_WORDS):
        acc = None
        for i in range(N_LIMBS):
            lo_bit = LIMB_BITS * i - 32 * w
            if lo_bit <= -LIMB_BITS or lo_bit >= 32:
                continue
            part = x[..., i] << lo_bit if lo_bit >= 0 else x[..., i] >> -lo_bit
            acc = part if acc is None else acc | part
        words.append(acc & 0xFFFFFFFF)
    return torch.stack(words, dim=-1)


def unpack_words(w: torch.Tensor) -> torch.Tensor:
    """[..., 8] 32-bit words (int64, or int32 holding the same bits) ->
    canonical limbs [..., 22] int32."""
    w = w.to(I64) & 0xFFFFFFFF
    limbs = []
    for i in range(N_LIMBS):
        bit = LIMB_BITS * i
        j, off = bit >> 5, bit & 31
        v = w[..., j] >> off
        if off > 32 - LIMB_BITS and j + 1 < PACK_WORDS:
            v = v | (w[..., j + 1] << (32 - off))
        limbs.append(v & LIMB_MASK)
    return torch.stack(limbs, dim=-1).to(I32)


def words_to_i32(w: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) int64 words -> int32 with the same bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(I32)


# ---------------------------------------------------------------------------
# Host codecs
# ---------------------------------------------------------------------------

def from_ints(spec: FieldSpec, xs, device="cpu") -> torch.Tensor:
    """Python ints -> [len, 22] canonical limbs on ``device``."""
    xs = [int(x) % spec.modulus for x in xs]
    if not xs:
        return torch.zeros((0, N_LIMBS), dtype=I32, device=device)
    arr = ints_to_limbs(xs).reshape(-1, N_LIMBS)
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def from_int(spec: FieldSpec, x: int, device="cpu") -> torch.Tensor:
    return const(spec, x, (), device).clone()


def to_ints(spec: FieldSpec, x: torch.Tensor) -> list:
    """[..., 22] -> flat list of canonical python ints (one device fetch;
    the canonicalisation runs on the host copy)."""
    arr = canon(spec, x.cpu()).numpy().reshape(-1, N_LIMBS).astype(object)
    acc = np.zeros(arr.shape[0], dtype=object)
    for i in range(N_LIMBS - 1, -1, -1):
        acc = (acc << LIMB_BITS) + arr[:, i]
    return [int(v) for v in acc]


def to_int(spec: FieldSpec, x: torch.Tensor) -> int:
    return to_ints(spec, x)[0]


from . import kernels as _kernels  # noqa: E402  (mul dispatches to kernels.mul)
