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

``r`` is a Python int, or a ``[22]`` int32 limb tensor on the tables'
device (any semi form; the device transcript squeezes it there, and the
kernel reads it from device memory, so no host sync sits between rounds).
Both forms of one value give the same bits.

Tables ``[B, n, 22]`` hold B instances of one size (spartan/batched.py):
the round runs on each, with ``r`` an int or a [22] tensor shared by all,
or a ``[B, 22]`` tensor, one challenge an instance, and returns ``[B, 3 or
2, 22]``.  It is what B calls on the instances compute, in one launch.

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

_SCRATCH_WORDS = 25  # 24 word accumulators and the ticket (SC_TICKET + 1), an instance
_scratch: dict = {}  # (device index, stream, instances) -> the kernel's zeroed scratch


def _check_args(tables, degree, r, prev_half):
    """-> (instances, or 0 for [n, 22] tables; n)."""
    if degree not in (2, 3):
        raise ValueError(f"degree must be 2 or 3, got {degree}")
    want = 4 if degree == 3 else 2
    if len(tables) != want:
        raise ValueError(f"degree {degree} takes {want} tables, got {len(tables)}")
    shape = tuple(tables[0].shape)
    if len(shape) not in (2, 3) or shape[-1] != N_LIMBS:
        raise ValueError(f"tables must be [n, 22] or [B, n, 22], got {shape}")
    for t in tables:
        if tuple(t.shape) != shape:
            raise ValueError(f"tables must share one shape, got {shape} and {tuple(t.shape)}")
    batch, n = (shape[0] if len(shape) == 3 else 0), shape[-2]
    if r is None:
        if n < 2 or n & (n - 1):
            raise ValueError("first round needs a power-of-two table of >= 2 rows")
        return batch, n
    if prev_half is None or prev_half < 1 or 2 * prev_half > n:
        raise ValueError(f"bad previous active half {prev_half} for n = {n}")
    if isinstance(r, torch.Tensor):
        shapes = [(N_LIMBS,)] + ([(batch, N_LIMBS)] if batch else [])
        if tuple(r.shape) not in shapes or r.dtype != torch.int32 \
                or r.device != tables[0].device:
            raise ValueError("a tensor challenge must be [22] (or [B, 22] for B instances) "
                             "int32 limbs on the tables' device")
    return batch, n


def sumcheck_round_plain(tables, degree: int, r=None, prev_half: int | None = None):
    """Plain-torch round (any device; tables [n, 22] or [B, n, 22], updated
    in place)."""
    _, n = _check_args(tables, degree, r, prev_half)
    if r is not None:
        ah = prev_half
        if isinstance(r, torch.Tensor):
            rl = r[..., None, :]  # [1, 22] or [B, 1, 22] against [.., ah, 22]
        else:
            rl = F.const(SCALAR, r, (), tables[0].device)
        for t in tables:
            lo, hi = t[..., :ah, :], t[..., ah : 2 * ah, :]
            bound = F.add(SCALAR, lo, mul_plain(SCALAR, F.sub(SCALAR, hi, lo), rl))
            t[..., :ah, :] = F.canon(SCALAR, bound)
        if ah == 1:
            return None
        h = ah // 2
    else:
        h = n // 2
    lo = [F.canon(SCALAR, t[..., :h, :]) for t in tables]
    d = [F.canon(SCALAR, F.sub(SCALAR, t[..., h : 2 * h, :], t[..., :h, :])) for t in tables]

    def ext(q, pt):
        if pt == 0:
            return lo[q]
        return F.add(SCALAR, lo[q], F.mul_small(SCALAR, d[q], pt))

    outs = []
    if degree == 3:
        for pt in (0, 2, 3):
            w = F.sub(SCALAR, mul_plain(SCALAR, ext(1, pt), ext(2, pt)), ext(3, pt))
            outs.append(F.sum_reduce(SCALAR, mul_plain(SCALAR, ext(0, pt), w), axis=-2))
    else:
        for pt in (0, 2):
            outs.append(F.sum_reduce(SCALAR, mul_plain(SCALAR, ext(0, pt), ext(1, pt)), axis=-2))
    return F.canon(SCALAR, torch.stack(outs, dim=-2))


def _scratch_for(dev: torch.device, stream: int, instances: int) -> torch.Tensor:
    """The accumulators and ticket of the kernel's cross-block sums, one set
    an instance: zeroed once here, and left zero by every launch (each
    instance's last block clears its own), so a round costs no memset.  One
    per device, stream and instance count, because launches that share it
    must be ordered, and a batched launch must not share the words of a
    single one."""
    key = (dev.index, stream, instances)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(instances * _SCRATCH_WORDS, dtype=torch.int64,
                                          device=dev)
    return buf


def sumcheck_round_cuda(tables, degree: int, r=None, prev_half: int | None = None):
    """The round by the CUDA kernel, one launch for [n, 22] tables or for B
    instances' [B, n, 22] (tables: contiguous int32 CUDA tensors; a previous
    active half must be a power of two; ``r`` an int, a [22] int32 tensor
    on the tables' device, or [B, 22] with B instances)."""
    batch, n = _check_args(tables, degree, r, prev_half)
    dev = tables[0].device
    for t in tables:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("sumcheck_round_cuda: tables must share one CUDA device")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("sumcheck_round_cuda: contiguous int32 tables required")
    k = 3 if degree == 3 else 2
    instances = max(batch, 1)
    r_words, r_dev, r_stride = np.zeros(8, np.uint32), None, 0
    if r is None:
        ah, half = 0, n // 2
    else:
        ah, half = prev_half, 0
        if ah & (ah - 1):
            raise ValueError(f"sumcheck_round_cuda: previous half {ah} is not a power of two")
        if isinstance(r, torch.Tensor):
            r_dev = r.contiguous()
            r_stride = N_LIMBS if r.dim() == 2 else 0
        else:
            r_words = np.frombuffer((r % SCALAR.modulus).to_bytes(32, "little"), "<u4")
    stream = _build.stream_ptr(tables[0])
    evals = None
    if ah != 1:
        evals = torch.empty(((batch,) if batch else ()) + (k, N_LIMBS), dtype=torch.int32,
                            device=dev)
    ptrs = [t.data_ptr() for t in tables] + [0] * (4 - len(tables))
    lib = _build.library()
    err = lib.otti_sumcheck_round(
        *ptrs, len(tables), instances, n, r_words.ctypes.data,
        0 if r_dev is None else r_dev.data_ptr(), r_stride, ah, half,
        _scratch_for(dev, stream, instances).data_ptr(),
        0 if evals is None else evals.data_ptr(), dev.index, stream,
    )
    if err != 0:  # the scratch may not have been left zero: the next call takes a new one
        _scratch.pop((dev.index, stream, instances), None)
    _build.check(err, "sumcheck_round")
    _build.LAUNCHES["sumcheck_round"] += 1
    return evals


def sumcheck_round(tables, degree: int, r=None, prev_half: int | None = None):
    """One round: the CUDA kernel for CUDA tables, plain torch for CPU."""
    dev = tables[0].device.type
    if dev == "cuda":
        return sumcheck_round_cuda(tables, degree, r, prev_half)
    if dev == "cpu":
        return sumcheck_round_plain(tables, degree, r, prev_half)
    raise ValueError(f"sumcheck_round: unsupported device {tables[0].device}")
