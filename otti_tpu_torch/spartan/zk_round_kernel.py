"""Kernel K6: one zero-knowledge sumcheck round after its evaluations, in
one launch (``csrc/zk_round.cu``, the round in ``csrc/zk_round.cuh``).

``zk_round_cuda`` does on the card what ``zkfused._zk_round_plain`` does in
torch ops: from the round's evaluations, the running claim and its blind,
the round's blinds, the comb table of G_0..G_degree and H, and the device
transcript's sponge state, it computes the round's coefficients, its
commitments (C_poly, delta; comm_eval; C_y, beta) and their encodings, its
transcript steps (comm_poly, r; comm_eval, w0, w1; the dot-product proof's
messages, c) and its sigma arithmetic, and returns (e_next, b_next, r, encs
[4, 32], z [degree + 1, 22], zdb [2, 22]), advancing the transcript's state
in place.  With a transcript of B states ([B, 200]) every argument may
carry a leading axis B (grid y of the launch); an argument without it is
shared by the B instances.  The results are canonical; the plain round
leaves e_next in a semi form of the same value.

Every round of a zk sumcheck starts and ends at the post-challenge offsets,
so its transcript steps are a fixed program of the labels
(``round_program``, checked on the host once a label and degree, as
``custom_kernels.round_program`` is for K5).  ``zkfused._zk_round_from_evals``
takes this kernel for CUDA tensors and the plain round for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..field.fields import N_LIMBS
from ..transcript.device import POST_CHALLENGE, _const_bytes
from ..transcript.merlin import transcript_from_strobe_state
from .custom_kernels import program_bytes

I32 = torch.int32


def round_labels(label: bytes) -> tuple:
    """The byte program's entries in csrc/zk_round.cuh's ZrLabel order (the
    seventh is the message the dot-product proof's protocol name carries)."""
    return (label + b"/comm_poly", label + b"/r", label + b"/comm_eval", label + b"/w0",
            label + b"/w1", b"protocol-name", b"dot product proof", b"Cx", b"Cy", b"a",
            b"delta", b"beta", b"c")


def transcript_steps(t, labels: tuple, degree: int) -> None:
    """A round's transcript steps on a host Transcript ``t`` in the kernel's
    order, with zero bytes for every encoding and weight: what they do to
    the STROBE offsets depends on the lengths alone."""
    (poly, r, comm_eval, w0, w1, proto, dot, cx, cy, a, delta, beta, c) = labels
    point = bytes(32)
    t.append_message(poly, point)
    t.challenge_bytes(r, 64)
    t.append_message(comm_eval, point)
    t.challenge_bytes(w0, 64)
    t.challenge_bytes(w1, 64)
    t.append_message(proto, dot)
    t.append_message(cx, point)
    t.append_message(cy, point)
    for _ in range(degree + 1):
        t.append_message(a, point)
    t.append_message(delta, point)
    t.append_message(beta, point)
    t.challenge_bytes(c, 64)


@functools.lru_cache(maxsize=None)
def step_offsets(label: bytes, degree: int, offsets: tuple) -> tuple:
    """The STROBE offsets after a round's steps from ``offsets``, by the
    host Merlin."""
    t = transcript_from_strobe_state(bytes(200), *offsets)
    transcript_steps(t, round_labels(label), degree)
    return t.strobe.pos, t.strobe.pos_begin, t.strobe.cur_flags


def round_program(label: bytes, degree: int, device):
    """The labels of every round of a zk sumcheck under ``label`` as the
    kernel reads them (uint8 on ``device``, uploaded once).  Raises
    ValueError unless a round returns to the post-challenge offsets, where
    the next one starts."""
    if step_offsets(label, degree, POST_CHALLENGE) != POST_CHALLENGE:
        raise ValueError("round_program: the round does not return to the post-challenge "
                         "offsets")
    return _const_bytes(program_bytes(round_labels(label)), device)


def _rows(x: torch.Tensor, inner: tuple, batch: int, dev, name: str) -> tuple:
    """An input of per-instance shape ``inner`` (optionally with a leading
    batch axis) -> (tensor, batch stride in elements): rows 8-byte aligned,
    the per-instance part contiguous (copied where it is not)."""
    if x.dtype != I32 or x.device != dev:
        raise ValueError(f"zk_round_cuda: {name} must be int32 on {dev}")
    if tuple(x.shape[x.dim() - len(inner):]) != inner or x.dim() > len(inner) + 1:
        raise ValueError(f"zk_round_cuda: {name} must be {list(inner)} or [B, *{list(inner)}], "
                         f"got {list(x.shape)}")
    batched = x.dim() == len(inner) + 1
    if batched and x.shape[0] != batch:
        raise ValueError(f"zk_round_cuda: {name} has {x.shape[0]} instances, the state {batch}")
    part = x[0] if batched else x
    if not part.is_contiguous() or x.data_ptr() % 8 or (batched and x.stride(0) % 2):
        x = x.contiguous()
    return x, x.stride(0) if batched else 0


def zk_round_cuda(label: bytes, degree: int, table: torch.Tensor, vinv: torch.Tensor, t, e, be,
                  evs, xs) -> tuple:
    """One launch of kernel K6.  ``table``: the packed comb table of G_0 ..
    G_degree and H (``zkfused._round_tables``); ``vinv``: the inverse
    Vandermonde matrix [degree + 1, degree + 1, 22]; ``t``: a
    DeviceTranscript at the post-challenge offsets; ``evs`` = [p(0), p(2)(,
    p(3))]; ``xs`` = (b_poly, b_next, d [degree + 1, 22], r_delta, r_beta).
    Returns what ``zkfused._zk_round_plain`` returns."""
    if degree not in (2, 3):
        raise ValueError(f"zk_round_cuda: degree 2 or 3, got {degree}")
    state = t.strobe.state
    dev = state.device
    if dev.type != "cuda":
        raise ValueError("zk_round_cuda: the transcript must be on a CUDA device")
    if t.strobe.offsets != POST_CHALLENGE:
        raise ValueError("zk_round_cuda: round not at the post-challenge offsets")
    if (state.dtype != torch.uint8 or state.dim() not in (1, 2) or state.shape[-1] != 200
            or not state.is_contiguous() or state.data_ptr() % 8):
        raise ValueError("zk_round_cuda: the state must be a contiguous 8-byte aligned uint8 "
                         "[200] or [B, 200] tensor")
    batch = state.shape[0] if state.dim() == 2 else 0
    nc = degree + 1
    n_entries = (nc + 1) * 32 * 256
    if (table.dtype != I32 or table.device != dev or table.dim() != 2 or table.shape[1] != 16
            or table.shape[0] < n_entries or not table.is_contiguous()
            or table.data_ptr() % 64):
        raise ValueError(f"zk_round_cuda: the comb table must be a contiguous int32 [>= "
                         f"{n_entries}, 16] tensor on {dev}")
    if (vinv.dtype != I32 or vinv.device != dev or tuple(vinv.shape) != (nc, nc, N_LIMBS)
            or not vinv.is_contiguous() or vinv.data_ptr() % 8):
        raise ValueError(f"zk_round_cuda: vinv must be a contiguous int32 [{nc}, {nc}, 22] tensor")
    b_poly, b_next, d_vec, r_delta, r_beta = xs
    row = (N_LIMBS,)
    ins = [_rows(x, inner, batch, dev, name) for x, inner, name in (
        (evs, (degree, N_LIMBS), "evs"), (e, row, "e"), (be, row, "be"),
        (b_poly, row, "b_poly"), (b_next, row, "b_next"), (d_vec, (nc, N_LIMBS), "d"),
        (r_delta, row, "r_delta"), (r_beta, row, "r_beta"))]
    lead = (batch,) if batch else ()
    e_next = torch.empty(lead + row, dtype=I32, device=dev)
    r = torch.empty(lead + row, dtype=I32, device=dev)
    encs = torch.empty(lead + (4, 32), dtype=torch.uint8, device=dev)
    z = torch.empty(lead + (nc, N_LIMBS), dtype=I32, device=dev)
    zdb = torch.empty(lead + (2, N_LIMBS), dtype=I32, device=dev)
    prog = round_program(label, degree, dev)
    args = np.array([x.data_ptr() for x, _ in ins] + [s for _, s in ins]
                    + [vinv.data_ptr(), table.data_ptr(), prog.data_ptr(), state.data_ptr(),
                       e_next.data_ptr(), r.data_ptr(), encs.data_ptr(), z.data_ptr(),
                       zdb.data_ptr()], dtype=np.int64)
    err = _build.library().otti_zk_round(args.ctypes.data, degree, max(batch, 1),
                                         *POST_CHALLENGE, dev.index, _build.stream_ptr(state))
    _build.check(err, "zk_round")
    _build.LAUNCHES["zk_round"] += 1
    return e_next, b_next, r, encs, z, zdb
