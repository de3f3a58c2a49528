"""Pedersen/Hyrax row commitments (port of otti_tpu/spartan/commitments.py).

Generators are derived on the host (SHAKE256 -> ristretto one-way map) from
a domain-separation label exactly as the JAX package derives them; all
bulk commitment work is the fixed-base comb MSM on the device.
"""

from __future__ import annotations

import functools

import torch

from ..field.fields import SCALAR
from ..native import ristretto_encode_host
from ..refimpl import numeric as ref
from ..transcript.keccak import shake256

from ..curve import edwards as E
from ..field import ops as F
from ..msm import pippenger


# copied from otti_tpu/spartan/commitments.py::gen_points_host
@functools.lru_cache(maxsize=None)
def gen_points_host(n: int, label: bytes) -> tuple:
    """n ristretto generators + blinding generator h (host EdPoints)."""
    pts = tuple(
        ref.EdPoint.from_uniform_bytes(
            shake256(b"otti-tpu gens" + label + i.to_bytes(8, "little"), 64)
        )
        for i in range(n)
    )
    h = ref.EdPoint.from_uniform_bytes(
        shake256(b"otti-tpu gens" + label + b"/blinding", 64)
    )
    return pts, h


def commit_rows(matrix_limbs, blinds: list, label: bytes, tbl: dict | None = None) -> dict:
    """Hyrax row commitments: [rows, cols, 22] scalars and one blind (host
    int) per row -> [rows] device points, sum_c W[r, c] * G_c + blind_r * H.
    All-zero blinds commit without the blind column, as the JAX package
    does.  An explicit ``tbl`` must match: built with H if any blind is
    nonzero."""
    cols = matrix_limbs.shape[1]
    with_blinds = any(blinds)
    if with_blinds:
        b = F.from_ints(SCALAR, blinds, matrix_limbs.device)
        matrix_limbs = torch.cat([matrix_limbs, b[:, None, :]], dim=1)
    return pippenger.msm_fixed_base(cols, label, matrix_limbs, with_blinds, tbl=tbl)


def encode_points(batch: dict) -> list:
    """Device points [n] -> 32-byte ristretto encodings: one canon per
    coordinate and one device->host transfer each, then the host library."""
    return [ristretto_encode_host(p) for p in E.to_refs(batch)]

