"""Kernel 5: one round of SPARK's custom-combination sumcheck (port of the
XLA round programs of otti_tpu/spartan/sumcheck.py: ``_custom_eval_kernel``,
``_custom_step_kernel`` and the scan body of ``_custom_seg_kernel``).

``stacked`` is the sumcheck's working copy of its k tables, ``[k, n, 22]``
int32 (SCALAR field), updated IN PLACE; ``consts`` is ``[kc, 22]``.  One
call:

* binds the previous challenge ``r`` into the active prefix of every table,
  ``t[j] <- t[j] + r * (t[j + ah] - t[j])`` for j < ah, where ``ah`` is the
  previous active half (``prev_half``); ``prev_half == 1`` is the bare
  final bind (row 0 only, nothing evaluated, returns None);
* evaluates the round polynomial ``sum_i comb(consts, X_t)`` over the pairs
  (t[i], t[i + h]), i < h (h = ah / 2 after a bind, n / 2 for the first
  round, ``r is None``), at the points t in ``_eval_points(degree)`` =
  0, 2, ..., degree, with X_t = lo + t (hi - lo).

Returns the evaluations as canonical limbs ``[degree, 22]``.  Rows past the
active prefix are left as they are.  ``r`` is a Python int, or a ``[22]``
int32 limb tensor on the tables' device (any semi form: the device
transcript squeezes it there, and the kernel reads it from device memory,
so no host sync sits between rounds).

The combination is looked up by key in a registry (``register_comb``; the
SPARK layer registers its two).  ``custom_round_plain`` runs the registered
Python combination in torch on any device, the reference the kernel is
held against on the card; ``custom_round_cuda`` launches the CUDA kernel of
``csrc/custom_round.cu``, which carries the two SPARK combinations
(``CUDA_COMBS``) and nothing else; ``custom_round`` takes the plain version
for CPU tables and the kernel for CUDA tables, and raises on any other
device or on a key the kernel lacks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.fields import N_LIMBS, SCALAR

from .. import _build
from ..field import ops as F

_COMB_REGISTRY: dict = {}

# key -> (combination id of csrc/custom_round.cu, tables, consts, degree)
CUDA_COMBS = {"spark_entry4": (0, 9, 4, 4), "spark_table": (1, 4, 2, 3)}

_SCRATCH_WORDS = 33  # 4 points x 8 word accumulators and the ticket
_scratch: dict = {}  # (device index, stream) -> the kernel's zeroed scratch


def register_comb(key: str, fn) -> None:
    """fn(consts: tuple of [22] limb vectors, exts: tuple of [..., 22]
    tensors, one per table) -> [..., 22] combined values per point (of
    degree <= the sumcheck's ``degree`` in each variable)."""
    _COMB_REGISTRY[key] = fn


def _eval_points(degree: int) -> tuple:
    return (0,) + tuple(range(2, degree + 1))


def _check_args(stacked, consts, key, degree, r, prev_half) -> int:
    """-> n, the rows of each table."""
    if key not in _COMB_REGISTRY:
        raise ValueError(f"no combination registered under {key!r}")
    if degree < 1:
        raise ValueError(f"degree must be at least 1, got {degree}")
    shape = tuple(stacked.shape)
    if len(shape) != 3 or shape[-1] != N_LIMBS:
        raise ValueError(f"tables must be stacked as [k, n, 22], got {shape}")
    if consts.dim() != 2 or consts.shape[-1] != N_LIMBS:
        raise ValueError(f"consts must be [kc, 22], got {tuple(consts.shape)}")
    if consts.device != stacked.device:
        raise ValueError("consts and tables on different devices")
    if key in CUDA_COMBS:
        _, k, kc, deg = CUDA_COMBS[key]
        if shape[0] != k or consts.shape[0] != kc:
            raise ValueError(f"{key} takes {k} tables and {kc} consts, "
                             f"got {shape[0]} and {consts.shape[0]}")
        if degree != deg:
            raise ValueError(f"{key} is of degree {deg}, got {degree}")
    n = shape[1]
    if r is None:
        if n < 2 or n & (n - 1):
            raise ValueError("first round needs a power-of-two table of >= 2 rows")
        return n
    if prev_half is None or prev_half < 1 or 2 * prev_half > n:
        raise ValueError(f"bad previous active half {prev_half} for n = {n}")
    if isinstance(r, torch.Tensor) and (tuple(r.shape) != (N_LIMBS,) or r.dtype != torch.int32
                                        or r.device != stacked.device):
        raise ValueError("a tensor challenge must be [22] int32 limbs on the tables' device")
    return n


def _custom_evals(stacked: torch.Tensor, half: int, consts: tuple, comb, degree: int):
    """The round polynomial of sum comb(tables) over the pairs (t[i],
    t[i + half]), i < half, at the points 0, 2, ..., degree -> canonical
    [degree, 22].  ``stacked`` is [k, n, 22]; the extensions at every point
    go through ``comb`` in one call ([points, half, 22] per table)."""
    lo, cur = stacked[:, :half], stacked[:, half : 2 * half]  # the tables at X = 0, 1
    d = F.sub(SCALAR, cur, lo)
    exts = [lo]
    for _ in range(2, degree + 1):
        cur = F.add(SCALAR, cur, d)
        exts.append(cur)
    per_table = torch.stack(exts, dim=1)  # [k, points, half, 22]
    vals = comb(consts, tuple(per_table.unbind(0)))
    return F.canon(SCALAR, F.sum_reduce(SCALAR, vals, axis=1))


def custom_round_plain(stacked: torch.Tensor, consts: torch.Tensor, key: str, degree: int,
                       r=None, prev_half: int | None = None):
    """The round in torch through the registered combination (any device;
    ``stacked`` updated in place, canonical where bound)."""
    n = _check_args(stacked, consts, key, degree, r, prev_half)
    if r is not None:
        ah = prev_half
        rl = r if isinstance(r, torch.Tensor) else F.from_int(SCALAR, r, stacked.device)
        lo, hi = stacked[:, :ah], stacked[:, ah : 2 * ah]
        stacked[:, :ah] = F.canon(SCALAR, F.add(SCALAR, lo, F.mul(SCALAR, F.sub(SCALAR, hi, lo),
                                                                   rl)))
        if ah == 1:
            return None
        half = ah // 2
    else:
        half = n // 2
    return _custom_evals(stacked, half, tuple(consts.unbind(0)), _COMB_REGISTRY[key], degree)


def _scratch_for(dev: torch.device, stream: int) -> torch.Tensor:
    """The accumulators and ticket of the kernel's cross-block sums: zeroed
    once here and left zero by every launch (its last block clears them),
    one set per device and stream, apart from kernel 2's."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(_SCRATCH_WORDS, dtype=torch.int64, device=dev)
    return buf


def custom_round_cuda(stacked: torch.Tensor, consts: torch.Tensor, key: str, degree: int,
                      r=None, prev_half: int | None = None):
    """The round by the CUDA kernel, one launch (``stacked``: a contiguous
    int32 [k, n, 22] CUDA tensor; ``key`` one of ``CUDA_COMBS``; a previous
    active half must be a power of two)."""
    if key not in CUDA_COMBS:
        raise ValueError(f"custom_round_cuda: no CUDA combination for {key!r}")
    n = _check_args(stacked, consts, key, degree, r, prev_half)
    dev = stacked.device
    if dev.type != "cuda":
        raise ValueError("custom_round_cuda: tables must be on a CUDA device")
    if stacked.dtype != torch.int32 or not stacked.is_contiguous():
        raise ValueError("custom_round_cuda: contiguous int32 tables required")
    consts = consts.to(torch.int32).contiguous()
    comb_id, k, kc, _ = CUDA_COMBS[key]
    r_words, r_dev = np.zeros(8, np.uint32), None
    if r is None:
        ah, half = 0, n // 2
    else:
        ah, half = prev_half, 0
        if ah & (ah - 1):
            raise ValueError(f"custom_round_cuda: previous half {ah} is not a power of two")
        if isinstance(r, torch.Tensor):
            r_dev = r.contiguous()
        else:
            r_words = np.frombuffer((r % SCALAR.modulus).to_bytes(32, "little"), "<u4")
    stream = _build.stream_ptr(stacked)
    evals = None if ah == 1 else torch.empty((degree, N_LIMBS), dtype=torch.int32, device=dev)
    err = _build.library().otti_custom_round(
        stacked.data_ptr(), k, n, comb_id, consts.data_ptr(), kc, r_words.ctypes.data,
        0 if r_dev is None else r_dev.data_ptr(), ah, half,
        _scratch_for(dev, stream).data_ptr(), 0 if evals is None else evals.data_ptr(),
        dev.index, stream,
    )
    if err != 0:  # the scratch may not have been left zero: the next call takes a new one
        _scratch.pop((dev.index, stream), None)
    _build.check(err, "custom_round")
    _build.LAUNCHES["custom_round"] += 1
    return evals


def custom_round(stacked: torch.Tensor, consts: torch.Tensor, key: str, degree: int,
                 r=None, prev_half: int | None = None):
    """One round: the CUDA kernel for CUDA tables, plain torch for CPU."""
    dev = stacked.device.type
    if dev == "cuda":
        return custom_round_cuda(stacked, consts, key, degree, r, prev_half)
    if dev == "cpu":
        return custom_round_plain(stacked, consts, key, degree, r, prev_half)
    raise ValueError(f"custom_round: unsupported device {stacked.device}")
