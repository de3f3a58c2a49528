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

The variable-base MSM (``msm``, port of the JAX module's windowed
Pippenger) keeps the JAX design, every step a batched torch op over
``edwards.add``/``double`` (so kernel 1 on the card): per window the points
are sorted by digit, the bucket sums come from a two-level segmented
Hillis-Steele scan (in chunks of SCAN_CHUNK, then over the chunks' tails),
the buckets are weighted by suffix sums, and the windows are combined MSB
first by doubling.  Windows run ``win_group`` at a time on a leading axis,
as the JAX module vmaps them.  The level-2 scan runs ceil(log2 m) steps
over m chunks; the JAX module's ``max(1, m.bit_length() - 1)`` is one step
short when m is no power of two (n = 96, 112, 176), where its sums lose a
carry.  ``msm_bitserial`` and ``msm_shared_bases`` are the JAX module's
bit-serial forms.
"""

from __future__ import annotations

import hashlib
import math
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
SCAN_CHUNK = 16


# ---------------------------------------------------------------------------
# Variable-base MSM (otti_tpu/msm/pippenger.py::msm and its steps)
# ---------------------------------------------------------------------------

def _digits(scalars: torch.Tensor, window: int) -> torch.Tensor:
    """[N, 22] limb scalars -> [n_windows, N] int64 window digits of the
    canonical values, row 0 the MSB window."""
    n_windows = math.ceil(SCALAR_BITS / window)
    bits = E.scalars_to_bits(scalars, n_windows * window)
    shaped = bits.reshape(bits.shape[:-1] + (n_windows, window))
    digits = (shaped * (1 << torch.arange(window, device=bits.device))).sum(-1)
    return digits.T.flip(0)


def _shift(p: dict, d: int, back: bool = False) -> dict:
    """Points [..., n] moved d places along their last axis, to higher
    places (lower with ``back``), the identity in the places left empty:
    the masked roll of the JAX scans."""
    n = p["x"].shape[-2]
    d = min(d, n)
    fill = E.identity(tuple(p["x"].shape[:-2]) + (d,), p["x"].device)
    return {c: torch.cat([a[..., d:, :], fill[c]] if back else [fill[c], a[..., : n - d, :]],
                         dim=-2) for c, a in p.items()}


def _run_starts(digits_sorted: torch.Tensor) -> torch.Tensor:
    """1 where a run of equal digits starts (the first place is one)."""
    starts = torch.ones_like(digits_sorted)
    starts[..., 1:] = (digits_sorted[..., 1:] != digits_sorted[..., :-1]).long()
    return starts


def _hs_step(flags: torch.Tensor, vals: dict, d: int) -> tuple:
    """One Hillis-Steele step of a segmented inclusive scan along the last
    axis: a place whose run has not started within its last d places adds
    the value d places back (out of range counts as a run start)."""
    n = flags.shape[-1]
    pred_f = torch.cat([torch.ones_like(flags[..., : min(d, n)]), flags[..., : max(n - d, 0)]],
                       dim=-1)
    summed = E.add(vals, _shift(vals, d))
    return flags | pred_f, E.select(flags == 0, summed, vals)


def _scatter_run_ends(digits_sorted: torch.Tensor, vals: dict, window: int) -> dict:
    """Each run's inclusive total (at its run's last place) into the
    [..., 2^w] bucket array, the identity in empty buckets."""
    nb = 1 << window
    ends = torch.ones_like(digits_sorted, dtype=torch.bool)
    ends[..., :-1] = digits_sorted[..., 1:] != digits_sorted[..., :-1]
    idx = torch.where(ends, digits_sorted, nb)[..., None].expand(vals["x"].shape)
    lead = tuple(digits_sorted.shape[:-1])
    ident = E.identity(lead + (nb + 1,), digits_sorted.device)
    return {c: ident[c].scatter(-2, idx, vals[c])[..., :nb, :] for c in E.COORDS}


def _segment_scan_1level(points: dict, digits_sorted: torch.Tensor, window: int) -> dict:
    """Single-level segmented scan over [..., n] sorted points: ceil(log2 n)
    full-width masked adds; for n that the two-level scan does not take."""
    n = digits_sorted.shape[-1]
    flags, vals = _run_starts(digits_sorted), points
    for j in range(max(1, (n - 1).bit_length())):
        flags, vals = _hs_step(flags, vals, 1 << j)
    return _scatter_run_ends(digits_sorted, vals, window)


def _segment_scan_bucket_sums(points: dict, digits_sorted: torch.Tensor, window: int) -> dict:
    """Points [..., n] sorted by digit -> [..., 2^w] bucket sums (identity
    for empty buckets) by the JAX module's two-level scan: the array cut
    into m chunks of C = SCAN_CHUNK, a segmented scan inside each chunk
    (log2 C steps), one over the m chunk tails (ceil(log2 m) steps: the
    carries across chunks), and one more masked add that applies them.
    The carry mask and the tail flags come from the true run starts
    (``or_flags``), not from the level-1 guard flags."""
    n = digits_sorted.shape[-1]
    C = SCAN_CHUNK
    if n % C or n // C < 2:
        return _segment_scan_1level(points, digits_sorted, window)
    m = n // C
    lead = tuple(digits_sorted.shape[:-1])
    s2 = _run_starts(digits_sorted).reshape(lead + (m, C))
    or_flags = (torch.cumsum(s2, dim=-1) > 0).long()
    vals = E.tree_map(lambda a: a.reshape(lead + (m, C, a.shape[-1])), points)
    flags = s2
    for j in range(C.bit_length() - 1):
        flags, vals = _hs_step(flags, vals, 1 << j)
    f2, v2 = or_flags[..., -1], E.tree_map(lambda a: a[..., -1, :], vals)
    for j in range((m - 1).bit_length()):
        f2, v2 = _hs_step(f2, v2, 1 << j)
    carry_in = E.tree_map(lambda a: a[..., None, :].expand(lead + (m, C, a.shape[-1])),
                          _shift(v2, 1))
    vals = E.select(or_flags == 0, E.add(vals, carry_in), vals)
    flat = E.tree_map(lambda a: a.reshape(lead + (n, a.shape[-1])), vals)
    return _scatter_run_ends(digits_sorted, flat, window)


def _aggregate_buckets(buckets: dict, window: int) -> dict:
    """sum_b b S_b over [..., 2^w] buckets: the suffix sums T_j = sum_{b >= j}
    S_b (w masked full-width adds), then the tree sum of T_1 .. T_{2^w - 1}."""
    T = buckets
    for j in range(window):
        T = E.add(T, _shift(T, 1 << j, back=True))
    return E.sum_points(E.tree_map(lambda a: a[..., 1:, :], T), axis=-2)


def pick_window(n: int) -> int:
    if n <= 16:
        return 2
    return max(2, min(12, int(math.log2(n)) - 3))


def msm(points: dict, scalars: torch.Tensor, window: int | None = None,
        win_group: int | None = None) -> dict:
    """sum_i scalars[i] * points[i]: points [N] (extended, canonical
    coordinates), scalars [N, 22] limbs -> one point.

    The windows go ``win_group`` at a time (a leading axis of every step,
    at most 2^17 point rows by default, as in the JAX module), padded with
    zero windows at the MSB end (digit 0: weight 0, an identity window)."""
    n = scalars.shape[0]
    w = window or pick_window(n)
    digits = _digits(scalars, w)
    n_win = digits.shape[0]
    if win_group is None:
        win_group = max(1, min(8, (1 << 17) // max(n, 1)))
    win_group = min(win_group, n_win)
    pad = (-n_win) % win_group
    if pad:
        digits = torch.cat([torch.zeros((pad, n), dtype=digits.dtype, device=digits.device),
                            digits])
    packed = E.to_affine_pack(points)  # 64 B a point for every window's permutation
    bks = []
    for dg in digits.split(win_group):
        dig_sorted, order = torch.sort(dg, dim=1, stable=True)
        bks.append(_segment_scan_bucket_sums(E.from_affine_pack(packed[order]), dig_sorted, w))
    wins = _aggregate_buckets(E.tree_map(lambda *xs: torch.cat(xs), *bks), w)
    total = E.identity((), scalars.device)
    for i in range(digits.shape[0]):  # Horner, MSB window first
        for _ in range(w):
            total = E.double(total)
        total = E.add(total, E.tree_map(lambda a: a[i], wins))
    return total


def msm_bitserial(points: dict, scalars: torch.Tensor) -> dict:
    """MSB-first bit-serial MSM: 253 doublings and masked tree sums."""
    bits = E.scalars_to_bits(scalars, SCALAR_BITS)
    ident = E.identity((scalars.shape[0],), scalars.device)
    acc = E.identity((), scalars.device)
    for t in range(SCALAR_BITS - 1, -1, -1):
        sel = E.select(bits[:, t] == 1, points, ident)
        acc = E.add(E.double(acc), E.sum_points(sel))
    return acc


def msm_shared_bases(points: dict, scalar_matrix: torch.Tensor) -> dict:
    """One MSM a row over shared bases: points [cols], scalars [rows, cols,
    22] -> [rows] points, bit-serial as ``msm_bitserial``."""
    rows, cols = scalar_matrix.shape[0], scalar_matrix.shape[1]
    bits = E.scalars_to_bits(scalar_matrix, SCALAR_BITS)
    g_b = E.tree_map(lambda a: a[None].expand((rows,) + a.shape), points)
    ident = E.identity((rows, cols), scalar_matrix.device)
    acc = E.identity((rows,), scalar_matrix.device)
    for t in range(SCALAR_BITS - 1, -1, -1):
        sel = E.select(bits[:, :, t] == 1, g_b, ident)
        acc = E.add(E.double(acc), E.sum_points(sel, axis=1))
    return acc


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
