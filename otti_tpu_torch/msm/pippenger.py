"""Fixed-base comb MSM (port of the fixed-base half of otti_tpu/msm/pippenger.py).

Comb table: T[j, win, d] = d * 2^(8 win) * G_j for every generator j,
window win < 32 and digit d < 256, stored packed affine (x | y as 16
32-bit words, 64 B per entry) in the JAX package's layout and order.  A
commitment to a [rows, cols] scalar matrix then needs no doublings: one
table gather per (column, window) digit and a balanced tree of adds.

The table is built by doubling instead of by 256 sequential additions per
window: the window bases 2^(8 win) G_j are scalar multiples computed on the
host, and the 256 multiples of every base come from 8 batched device levels
(2k = dbl(k), 2k + 1 = 2k + base).
It is cached under ``otti_tpu_torch/build/``, keyed like the JAX cache.
"""

from __future__ import annotations

import hashlib
import os

import torch

from ..field.fields import BASE
from ..native import scalar_mul_host

from .. import _build
from ..curve import edwards as E
from ..field import ops as F

SCALAR_BITS = 253
FIXED_BASE_WINDOW = 8


N_WIN = -(-SCALAR_BITS // FIXED_BASE_WINDOW)  # 32 windows
N_DIGITS = 1 << FIXED_BASE_WINDOW  # 256 digits


def build_comb_table(gens: list, device) -> torch.Tensor:
    """Packed comb table [G * N_WIN * N_DIGITS, 16] int32 of host points."""
    n_win, n_d, g = N_WIN, N_DIGITS, len(gens)
    # window bases 2^(8 win) G_j on the host (native scalar multiplication:
    # one call each, instead of a chain of 248 dependent device doublings)
    host = [scalar_mul_host(p, 1 << (FIXED_BASE_WINDOW * w)) for p in gens for w in range(n_win)]
    base = E.pt(*(
        F.from_ints(BASE, [getattr(q, c) for q in host], device).reshape(g, n_win, -1)
        for c in "XYZT"
    ))  # [G, n_win]
    # multiples [k, G, n_win]: level by level, 2k = dbl(k) and 2k + 1 = 2k + base
    mults = E.stack([E.identity((g, n_win), device), base])
    while mults["x"].shape[0] < n_d:
        k = mults["x"].shape[0]
        evens = E.double(E.tree_map(lambda a: a[k // 2 :], mults))
        odds = E.add(evens, base)
        mults = E.tree_map(
            lambda m, e, o: torch.cat([m, torch.stack([e, o], dim=1).flatten(0, 1)]),
            mults, evens, odds,
        )
    # [n_d, G, n_win] -> [G, n_win, n_d]: entry (j * n_win + win) * n_d + d
    flat = E.tree_map(lambda a: a.permute(1, 2, 0, 3).reshape(-1, a.shape[-1]), mults)
    return E.to_affine_pack(flat)


def _packed_table(n_gens: int, label: bytes, with_blind: bool, device) -> torch.Tensor:
    """The packed comb table from its file under the build directory, or
    built and saved there.  The table with H is the table without it plus
    the 32 windows of H, so it costs one more generator where that one is
    cached already."""
    from ..spartan.commitments import gen_points_host

    digest = hashlib.sha256(
        b"combtbl-v2|%d|%d|%d|%s" % (n_gens, FIXED_BASE_WINDOW, with_blind, label)
    ).hexdigest()[:24]
    path = os.path.join(_build.BUILD_DIR, f"combtbl-{digest}.pt")
    if os.path.exists(path):
        return torch.load(path).to(device)
    gens, h = gen_points_host(n_gens, label)
    if with_blind:
        packed = torch.cat([_packed_table(n_gens, label, False, device),
                            build_comb_table([h], device)])
    else:
        packed = build_comb_table(list(gens), device)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(packed.cpu(), tmp)
    os.replace(tmp, path)
    return packed


def fixed_base_tables(n_gens: int, label: bytes, with_blind: bool = False,
                      device="cpu") -> dict:
    """Comb tables of the first ``n_gens`` generators of ``label``, cached
    on disk and per process.  With ``with_blind`` the blinding generator H
    is the table's last generator (index ``n_gens``); the cache keys carry
    the flag, so a table with H is never served from one without."""
    key = (n_gens, label, bool(with_blind), str(device))
    tbl = _TABLES.get(key)
    if tbl is None:
        tbl = _TABLES[key] = {"p": _packed_table(n_gens, label, bool(with_blind), device)}
    return tbl


_TABLES: dict = {}


def window_digits(scalars: torch.Tensor) -> torch.Tensor:
    """[..., 22] scalars -> [..., N_WIN] int64 8-bit window digits (LSB
    window first)."""
    bits = E.scalars_to_bits(scalars, N_WIN * FIXED_BASE_WINDOW)
    shaped = bits.reshape(bits.shape[:-1] + (N_WIN, FIXED_BASE_WINDOW))
    weights = 1 << torch.arange(FIXED_BASE_WINDOW, device=bits.device)
    return (shaped * weights).sum(-1)


def msm_fixed_base(n_gens: int, label: bytes, scalar_matrix: torch.Tensor,
                   with_blind: bool = False, tbl: dict | None = None) -> dict:
    """Batched fixed-base MSM: [rows, cols, 22] scalars (cols <= n_gens, plus
    one blind column with ``with_blind``) -> [rows] points,
    sum_c s[r, c] * G_c (+ s[r, -1] * H).  An explicit ``tbl`` must have been
    built with the same ``with_blind``."""
    device = scalar_matrix.device
    if tbl is None:
        tbl = fixed_base_tables(n_gens, label, with_blind, device)
    rows, cols = scalar_matrix.shape[0], scalar_matrix.shape[1]
    digits = window_digits(scalar_matrix)  # [rows, cols, N_WIN]
    gen_idx = torch.arange(cols, device=device)
    if with_blind:  # the blind scalar is the LAST column -> generator H
        gen_idx[-1] = n_gens
    gen_idx = gen_idx[None, :, None]
    win_idx = torch.arange(N_WIN, device=device)[None, None, :]
    flat = (gen_idx * N_WIN + win_idx) * N_DIGITS + digits
    gathered = E.from_affine_pack(tbl["p"][flat.reshape(rows, cols * N_WIN)])
    return E.sum_points(gathered, axis=1)
