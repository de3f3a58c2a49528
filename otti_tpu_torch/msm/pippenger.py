"""Fixed-base comb MSM (port of the fixed-base half of otti_tpu/msm/pippenger.py).

Comb table: T[j, win, d] = d * 2^(8 win) * G_j for every generator j,
window win < 32 and digit d < 256, stored packed affine (x | y as 16
32-bit words, 64 B per entry) in the JAX package's layout and order.  A
commitment to a [rows, cols] scalar matrix then needs no doublings: one
table gather per (column, window) digit and a balanced tree of adds.

The table is built by doubling instead of by 256 sequential additions per
window: the window bases 2^(8 win) G_j are scalar multiples computed on the
host, and the 256 multiples of every base come from 8 batched device levels
(2k = dbl(k), 2k + 1 = 2k + base).  For a CPU device it is built by host
integer arithmetic instead (``build_comb_table_host``, the same bits).
It is cached under ``otti_tpu_torch/build/``, keyed like the JAX cache, and
a table of fewer generators of one label is a prefix of a wider one.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..field.fields import BASE
from ..native import scalar_mul_host
from ..refimpl import numeric as ref

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


def build_comb_table_host(gens: list) -> torch.Tensor:
    """The same table by integer arithmetic on the host, for a CPU device:
    there the batched levels above run through the plain field multiply and
    take ten times as long."""
    entries = []
    for p in gens:
        for w in range(N_WIN):
            base = scalar_mul_host(p, 1 << (FIXED_BASE_WINDOW * w))
            acc = ref.EdPoint.identity()
            for _ in range(N_DIGITS):
                entries.append(acc)
                acc = acc + base
    # Montgomery's trick: every 1 / Z from one inversion
    prefix, run = [], 1
    for q in entries:
        prefix.append(run)
        run = run * q.Z % ref.P
    inv = pow(run, ref.P - 2, ref.P)
    raw = bytearray(64 * len(entries))
    for i in range(len(entries) - 1, -1, -1):
        q = entries[i]
        zinv = inv * prefix[i] % ref.P
        inv = inv * q.Z % ref.P
        raw[64 * i : 64 * i + 32] = (q.X * zinv % ref.P).to_bytes(32, "little")
        raw[64 * i + 32 : 64 * i + 64] = (q.Y * zinv % ref.P).to_bytes(32, "little")
    words = np.frombuffer(bytes(raw), dtype="<u4").view(np.int32).reshape(-1, 16)
    return torch.from_numpy(words.copy())


def _table_builder(device):
    if torch.device(device).type == "cpu":
        return build_comb_table_host
    return lambda gens: build_comb_table(gens, device)


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
        packed = torch.cat([fixed_base_tables(n_gens, label, False, device)["p"],
                            _table_builder(device)([h])])
    else:
        packed = _table_builder(device)(list(gens))
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
    if tbl is None and not with_blind:
        # generator j's entries come before generator j + 1's: a wider table
        # of the same label holds this one as a prefix (a view, no copy)
        for (n, lbl, blind, dev_name), wider in _TABLES.items():
            if n > n_gens and (lbl, blind, dev_name) == (label, False, str(device)):
                tbl = _TABLES[key] = {"p": wider["p"][: n_gens * N_WIN * N_DIGITS]}
                break
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


# Points one pass of msm_fixed_base gathers at most: the gathered entries
# and the add tree's temporaries take 1.6-1.9 KB a point on an H100
# (PERF.md), so a larger matrix goes through in passes of rows (a power of
# two of them) that give the same points: a pass of 2^21 points added
# 3,315 MiB at the peak there, and a Hyrax grid of up to 128 x 256 still
# commits in one pass.
MSM_PASS_POINTS = 1 << 21


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
    per_pass = 1 << max(0, (MSM_PASS_POINTS // (cols * N_WIN)).bit_length() - 1)
    if rows > per_pass:
        parts = [msm_fixed_base(n_gens, label, scalar_matrix[i : i + per_pass], with_blind, tbl)
                 for i in range(0, rows, per_pass)]
        return E.tree_map(lambda *xs: torch.cat(xs), *parts)
    digits = window_digits(scalar_matrix)  # [rows, cols, N_WIN]
    gen_idx = torch.arange(cols, device=device)
    if with_blind:  # the blind scalar is the LAST column -> generator H (no host copy)
        gen_idx = gen_idx + (gen_idx == cols - 1) * (n_gens - cols + 1)
    gen_idx = gen_idx[None, :, None]
    win_idx = torch.arange(N_WIN, device=device)[None, None, :]
    flat = (gen_idx * N_WIN + win_idx) * N_DIGITS + digits
    gathered = E.from_affine_pack(tbl["p"][flat.reshape(rows, cols * N_WIN)])
    return E.sum_points(gathered, axis=1)
