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

A device-transcript round (``custom_round_fs``, the scan body of the JAX
package's ``_custom_seg_kernel``) is the round followed by its transcript
step: the evaluations absorbed into a device transcript's ``uint8[200]``
state under the labels ``label/e0, label/e2, ...``, the challenge
``label/r`` squeezed and reduced.  It writes the evaluations into a row of
the caller's ``[mu, degree, 22]`` buffer and the challenge into a row of
its ``[mu, 22]`` buffer, where the next round's bind reads it.
``custom_round_fs_cuda`` is one launch of the kernel's fused entry;
``custom_round_fs_plain`` is ``custom_round_plain`` followed by the torch
``DeviceTranscript`` steps.  Every round of a sumcheck starts and ends at
the post-challenge offsets, so its transcript step is a fixed program of
the labels (``round_program``, checked on the host once a sumcheck).
"""

from __future__ import annotations

import functools
from collections import namedtuple

import numpy as np
import torch

from ..field.fields import N_LIMBS, SCALAR

from .. import _build
from ..field import ops as F
from ..transcript.device import (_RATE, POST_CHALLENGE, DeviceStrobe, DeviceTranscript,
                                 _const_bytes)
from ..transcript.merlin import transcript_from_strobe_state

_COMB_REGISTRY: dict = {}

# key -> (combination id of csrc/custom_round.cu, tables, consts, degree)
CUDA_COMBS = {"spark_entry4": (0, 9, 4, 4), "spark_table": (1, 4, 2, 3)}

_SCRATCH_WORDS = 161  # 4 points x 5 sums x 8 word accumulators and the ticket
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


def _cuda_args(stacked, consts, key, degree, r, prev_half, what):
    """Checks a launch's arguments -> (the C entries' leading arguments,
    tables .. scratch; what they point into, to keep alive over the launch;
    ah; the stream).  The rows a round reads are canonical when the
    previous launch wrote them: every round after the first bind."""
    if key not in CUDA_COMBS:
        raise ValueError(f"{what}: no CUDA combination for {key!r}")
    n = _check_args(stacked, consts, key, degree, r, prev_half)
    dev = stacked.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tables must be on a CUDA device")
    if stacked.dtype != torch.int32 or not stacked.is_contiguous():
        raise ValueError(f"{what}: contiguous int32 tables required")
    consts = consts.to(torch.int32).contiguous()
    comb_id, k, kc, _ = CUDA_COMBS[key]
    r_words, r_dev = np.zeros(8, np.uint32), None
    if r is None:
        ah, half = 0, n // 2
    else:
        ah, half = prev_half, 0
        if ah & (ah - 1):
            raise ValueError(f"{what}: previous half {ah} is not a power of two")
        if isinstance(r, torch.Tensor):
            r_dev = r.contiguous()
        else:
            r_words = np.frombuffer((r % SCALAR.modulus).to_bytes(32, "little"), "<u4")
    canon = int(ah == 0 or 2 * ah == n)
    stream = _build.stream_ptr(stacked)
    args = [stacked.data_ptr(), k, n, comb_id, consts.data_ptr(), kc, r_words.ctypes.data,
            0 if r_dev is None else r_dev.data_ptr(), ah, half, canon,
            _scratch_for(dev, stream).data_ptr()]
    return args, (consts, r_words, r_dev), ah, stream


def _launched(err: int, dev: torch.device, stream: int, what: str) -> None:
    if err != 0:  # the scratch may not have been left zero: the next call takes a new one
        _scratch.pop((dev.index, stream), None)
    _build.check(err, what)
    _build.LAUNCHES["custom_round"] += 1


def custom_round_cuda(stacked: torch.Tensor, consts: torch.Tensor, key: str, degree: int,
                      r=None, prev_half: int | None = None):
    """The round by the CUDA kernel, one launch (``stacked``: a contiguous
    int32 [k, n, 22] CUDA tensor; ``key`` one of ``CUDA_COMBS``; a previous
    active half must be a power of two; after the first bind the active
    prefix must be as the previous round left it, canonical)."""
    args, _keep, ah, stream = _cuda_args(stacked, consts, key, degree, r, prev_half,
                                         "custom_round_cuda")
    dev = stacked.device
    evals = None if ah == 1 else torch.empty((degree, N_LIMBS), dtype=torch.int32, device=dev)
    err = _build.library().otti_custom_round(
        *args, 0 if evals is None else evals.data_ptr(), dev.index, stream)
    _launched(err, dev, stream, "custom_round")
    return evals


# ---------------------------------------------------------------------------
# the round with its transcript step
# ---------------------------------------------------------------------------

# labels: label/e_p for the points p, then label/r; offsets: the STROBE
# offsets the step starts and ends at; buf: the labels as the kernel reads
# them (csrc/strobe.cuh::merlin_round), uint8 on the device
RoundProgram = namedtuple("RoundProgram", "labels offsets buf")
_MAX_PROGRAM = 256  # bytes (CR_MAXPROG of csrc/custom_round.cu)


@functools.lru_cache(maxsize=None)
def _step_offsets(labels: tuple, offsets: tuple) -> tuple:
    """The STROBE offsets after a round's transcript step from ``offsets``
    (pos, pos_begin, cur_flags), by the host Merlin: they depend on the
    lengths alone, so any state and values will do."""
    t = transcript_from_strobe_state(bytes(200), *offsets)
    for lbl in labels[:-1]:
        t.append_scalar(lbl, bytes(32))
    t.challenge_bytes(labels[-1], 64)
    return t.strobe.pos, t.strobe.pos_begin, t.strobe.cur_flags


def round_program(label: bytes, degree: int, device, offsets: tuple = POST_CHALLENGE):
    """The transcript step of every round of a degree-``degree`` sumcheck
    under ``label``, for a state at ``offsets``.  Raises ValueError unless
    the step leaves the state at ``offsets`` again (so that one program
    serves every round)."""
    labels = tuple(label + b"/e%d" % p for p in _eval_points(degree)) + (label + b"/r",)
    buf = program_bytes(labels)
    if len(buf) > _MAX_PROGRAM:
        raise ValueError(f"round_program: the labels take more than {_MAX_PROGRAM} bytes")
    if not 0 <= offsets[0] < _RATE or _step_offsets(labels, tuple(offsets)) != tuple(offsets):
        raise ValueError(f"round_program: the step does not return to the offsets {offsets}")
    return RoundProgram(labels, tuple(offsets), _const_bytes(buf, device))


def program_bytes(labels: tuple) -> bytes:
    """The labels as csrc/strobe.cuh::merlin_round reads them: their count,
    their lengths, then the labels one after another."""
    return bytes([len(labels)]) + bytes(len(lbl) for lbl in labels) + b"".join(labels)


def _check_fs(stacked, degree, state, program, evals_out, r_out) -> None:
    dev = stacked.device
    for name, t, dtype, shape in (("state", state, torch.uint8, (200,)),
                                  ("evals_out", evals_out, torch.int32, (degree, N_LIMBS)),
                                  ("r_out", r_out, torch.int32, (N_LIMBS,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} tensor on the "
                             "tables' device")
    if len(program.labels) != len(_eval_points(degree)) + 1 or program.buf.device != dev:
        raise ValueError("the round program is for another degree or device")


def custom_round_fs_plain(stacked, consts, key: str, degree: int, state, program, evals_out,
                          r_out, r=None, prev_half: int | None = None) -> None:
    """custom_round_plain, then the transcript step by the torch
    DeviceTranscript on ``state`` (updated in place): the evaluations into
    ``evals_out``, the challenge into ``r_out``."""
    if prev_half == 1:
        raise ValueError("the bare final bind has no transcript step")
    _check_fs(stacked, degree, state, program, evals_out, r_out)
    ev = custom_round_plain(stacked, consts, key, degree, r, prev_half)
    evals_out.copy_(ev)
    t = DeviceTranscript(_strobe=DeviceStrobe(_raw=(state, *program.offsets)))
    for lbl, v in zip(program.labels, ev):
        t.append_scalar_limbs(lbl, v)
    r_out.copy_(t.challenge_scalar_limbs(program.labels[-1]))
    assert t.strobe.offsets == program.offsets


def custom_round_fs_cuda(stacked, consts, key: str, degree: int, state, program, evals_out,
                         r_out, r=None, prev_half: int | None = None) -> None:
    """The same in one launch of the kernel's fused entry."""
    if prev_half == 1:
        raise ValueError("the bare final bind has no transcript step")
    args, _keep, _, stream = _cuda_args(stacked, consts, key, degree, r, prev_half,
                                        "custom_round_fs_cuda")
    _check_fs(stacked, degree, state, program, evals_out, r_out)
    dev = stacked.device
    err = _build.library().otti_custom_round_fs(
        *args, evals_out.data_ptr(), state.data_ptr(), program.buf.data_ptr(),
        program.buf.numel(), *program.offsets, r_out.data_ptr(), dev.index, stream)
    _launched(err, dev, stream, "custom_round_fs")


def custom_round_fs(stacked, consts, key: str, degree: int, state, program, evals_out, r_out,
                    r=None, prev_half: int | None = None) -> None:
    """One device-transcript round: the kernel for CUDA tables, plain torch
    for CPU."""
    dev = stacked.device.type
    if dev == "cuda":
        return custom_round_fs_cuda(stacked, consts, key, degree, state, program, evals_out,
                                    r_out, r, prev_half)
    if dev == "cpu":
        return custom_round_fs_plain(stacked, consts, key, degree, state, program, evals_out,
                                     r_out, r, prev_half)
    raise ValueError(f"custom_round_fs: unsupported device {stacked.device}")


def custom_round(stacked: torch.Tensor, consts: torch.Tensor, key: str, degree: int,
                 r=None, prev_half: int | None = None):
    """One round: the CUDA kernel for CUDA tables, plain torch for CPU."""
    dev = stacked.device.type
    if dev == "cuda":
        return custom_round_cuda(stacked, consts, key, degree, r, prev_half)
    if dev == "cpu":
        return custom_round_plain(stacked, consts, key, degree, r, prev_half)
    raise ValueError(f"custom_round: unsupported device {stacked.device}")
