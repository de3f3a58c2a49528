"""Kernel 2: the fused sumcheck round (port of otti_tpu/spartan/pallas_sumcheck.py).

One call does one round of either sumcheck phase on tables ``[n, 22]``
int32 (SCALAR field), updating them IN PLACE:

* bind the previous challenge ``r`` into the active prefix,
  ``t[i] <- t[i] + r * (t[i + ah] - t[i])`` for i < ah, where ``ah`` is the
  previous active half (``prev_half``); ``prev_half == 1`` is the bare
  final bind (position 0 only, nothing evaluated);
* evaluate the round polynomial over the pairs (t[i], t[i + h]), i < h
  (h = ah / 2 after a bind, n / 2 for the first round, ``r is None``):
  degree 3 on (eq, A, B, C): sum eq_t (A_t B_t - C_t) at t = 0, 2, 3;
  degree 2 on (M, Z): sum M_t Z_t at t = 0, 2.

Returns the evaluations as canonical limbs ``[3 or 2, 22]`` (None after the
bare final bind).  Entries past the active prefix are left as they are.

``sumcheck_round`` launches the CUDA kernel of ``csrc/sumcheck_round.cu``
for CUDA tables and runs ``sumcheck_round_plain`` for CPU tables;
``sumcheck_round_plain`` is the same function in plain torch on any
device, the reference the kernel is held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.fields import N_LIMBS, SCALAR

from .. import _build
from ..field import ops as F
from ..field.kernels import mul_plain

_SCRATCH_WORDS = 25  # 24 word accumulators and the ticket (SC_TICKET + 1)
_scratch: dict = {}  # (device index, stream) -> the kernel's zeroed scratch


def _check_args(tables, degree, r, prev_half):
    if degree not in (2, 3):
        raise ValueError(f"degree must be 2 or 3, got {degree}")
    want = 4 if degree == 3 else 2
    if len(tables) != want:
        raise ValueError(f"degree {degree} takes {want} tables, got {len(tables)}")
    n = tables[0].shape[0]
    for t in tables:
        if t.shape != (n, N_LIMBS):
            raise ValueError(f"tables must share the shape [n, 22], got {tuple(t.shape)}")
    if r is None:
        if n < 2 or n & (n - 1):
            raise ValueError("first round needs a power-of-two table of >= 2 rows")
    elif prev_half is None or prev_half < 1 or 2 * prev_half > n:
        raise ValueError(f"bad previous active half {prev_half} for n = {n}")
    return n


def sumcheck_round_plain(tables, degree: int, r: int | None = None,
                         prev_half: int | None = None):
    """Plain-torch round (any device; tables updated in place)."""
    n = _check_args(tables, degree, r, prev_half)
    if r is not None:
        ah = prev_half
        rl = F.const(SCALAR, r, (), tables[0].device)
        for t in tables:
            lo, hi = t[:ah], t[ah : 2 * ah]
            bound = F.add(SCALAR, lo, mul_plain(SCALAR, F.sub(SCALAR, hi, lo), rl))
            t[:ah] = F.canon(SCALAR, bound)
        if ah == 1:
            return None
        h = ah // 2
    else:
        h = n // 2
    lo = [F.canon(SCALAR, t[:h]) for t in tables]
    d = [F.canon(SCALAR, F.sub(SCALAR, t[h : 2 * h], t[:h])) for t in tables]

    def ext(q, pt):
        if pt == 0:
            return lo[q]
        return F.add(SCALAR, lo[q], F.mul_small(SCALAR, d[q], pt))

    outs = []
    if degree == 3:
        for pt in (0, 2, 3):
            w = F.sub(SCALAR, mul_plain(SCALAR, ext(1, pt), ext(2, pt)), ext(3, pt))
            outs.append(F.sum_reduce(SCALAR, mul_plain(SCALAR, ext(0, pt), w)))
    else:
        for pt in (0, 2):
            outs.append(F.sum_reduce(SCALAR, mul_plain(SCALAR, ext(0, pt), ext(1, pt))))
    return F.canon(SCALAR, torch.stack(outs))


def _scratch_for(dev: torch.device, stream: int) -> torch.Tensor:
    """The accumulators and ticket of the kernel's cross-block sum: zeroed
    once here, and left zero by every launch (its last block clears them),
    so a round costs no memset.  One per device and stream, because
    launches that share it must be ordered."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(_SCRATCH_WORDS, dtype=torch.int64, device=dev)
    return buf


def sumcheck_round_cuda(tables, degree: int, r: int | None = None,
                        prev_half: int | None = None):
    """The round by the CUDA kernel, one launch (tables: contiguous int32
    CUDA tensors; a previous active half must be a power of two)."""
    n = _check_args(tables, degree, r, prev_half)
    dev = tables[0].device
    for t in tables:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("sumcheck_round_cuda: tables must share one CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("sumcheck_round_cuda: contiguous int32 tables required")
    k = 3 if degree == 3 else 2
    if r is None:
        ah, half = 0, n // 2
        r_words = np.zeros(8, np.uint32)
    else:
        ah, half = prev_half, 0
        if ah & (ah - 1):
            raise ValueError(f"sumcheck_round_cuda: previous half {ah} is not a power of two")
        r_words = np.frombuffer((r % SCALAR.modulus).to_bytes(32, "little"), "<u4")
    stream = _build.stream_ptr(tables[0])
    evals = None if ah == 1 else torch.empty((k, N_LIMBS), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in tables] + [0] * (4 - len(tables))
    lib = _build.library()
    err = lib.otti_sumcheck_round(
        *ptrs, len(tables), r_words.ctypes.data, ah, half,
        _scratch_for(dev, stream).data_ptr(),
        0 if evals is None else evals.data_ptr(), stream,
    )
    if err != 0:  # the scratch may not have been left zero: the next call takes a new one
        _scratch.pop((dev.index, stream), None)
    _build.check(err, "sumcheck_round")
    _build.LAUNCHES["sumcheck_round"] += 1
    return evals


def sumcheck_round(tables, degree: int, r: int | None = None,
                   prev_half: int | None = None):
    """One round: the CUDA kernel for CUDA tables, plain torch for CPU."""
    dev = tables[0].device.type
    if dev == "cuda":
        return sumcheck_round_cuda(tables, degree, r, prev_half)
    if dev == "cpu":
        return sumcheck_round_plain(tables, degree, r, prev_half)
    raise ValueError(f"sumcheck_round: unsupported device {tables[0].device}")
