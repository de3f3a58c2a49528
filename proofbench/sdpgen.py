"""SDPs made from a seed in an SDPLIB instance's published shape.

The problem is SDPLIB's: min <C, X> over X >= 0 (positive semidefinite)
with <A_i, X> = b_i, whose dual is max b.y with S = C - sum y_i A_i >= 0;
C and every A_i are symmetric and block-diagonal in the published blocks.

Each block of size n_k gets an orthogonal Q drawn from the seed and a
strictly complementary optimal pair planted in it: X* = Q diag(lam, 0) Q^T
and Z* = Q diag(0, mu) Q^T, lam and mu in [1, 3], X* of rank n_k // 2.
A_1 is a weighted trace (integers 1-3 on the whole diagonal), so the primal
feasible set is bounded and the dual has an interior point; every other A_i
holds 2 + n_k // 10 entries in the upper triangle of each block, integers
+-1 to +-3 at places drawn from the seed.  With integers y* in -3..3,
C = Z* + sum y*_i A_i and b_i = <A_i, X*>: (X*, y*, Z*) is optimal and b.y*
is the optimum.  Every number is written by ``repr``, so that
``io/sdpa.parse_dats`` reads back the very doubles ``make_sdp`` returns.
"""

from __future__ import annotations

import typing

import numpy as np


class SDP(typing.NamedTuple):
    C: np.ndarray  # [n, n]
    A: list  # m matrices [n, n]
    b: np.ndarray  # [m]
    X: np.ndarray  # the planted primal optimum
    y: np.ndarray  # the planted dual optimum


def _symmetric(M: np.ndarray) -> np.ndarray:
    """M's upper triangle mirrored: what the file holds and the parser makes."""
    return np.triu(M) + np.triu(M, 1).T


def _orthogonal(rng, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.where(np.diag(r) < 0, -1.0, 1.0)


def make_sdp(m: int, blocks: list, seed: int, index: int = 0) -> SDP:
    """Instance ``index`` of the run seeded ``seed``: ``m`` constraints,
    blocks of the sizes ``blocks``."""
    if m < 1 or not blocks or min(blocks) < 2:
        raise ValueError(f"no SDP of {m} constraints and blocks {blocks}")
    rng = np.random.default_rng([seed % 2**64, index, 5 << 20])
    n = sum(blocks)
    offsets = np.cumsum([0] + list(blocks[:-1]))
    X, Z = np.zeros((n, n)), np.zeros((n, n))
    A = [np.zeros((n, n)) for _ in range(m)]
    for off, nk in zip(offsets, blocks):
        q = _orthogonal(rng, nk)
        r = nk // 2
        lam = np.concatenate([rng.uniform(1, 3, r), np.zeros(nk - r)])
        mu = np.concatenate([np.zeros(r), rng.uniform(1, 3, nk - r)])
        blk = slice(off, off + nk)
        X[blk, blk] = (q * lam) @ q.T
        Z[blk, blk] = (q * mu) @ q.T
        diag = np.arange(off, off + nk)
        A[0][diag, diag] = rng.integers(1, 4, nk)
        iu, ju = np.triu_indices(nk)
        for Ai in A[1:]:
            at = rng.choice(iu.size, size=2 + nk // 10, replace=False)
            vals = rng.integers(1, 4, at.size) * rng.choice([-1, 1], at.size)
            Ai[off + iu[at], off + ju[at]] = vals
    A = [_symmetric(Ai) for Ai in A]
    X, Z = _symmetric(X), _symmetric(Z)
    y = rng.integers(-3, 4, m).astype(float)
    C = _symmetric(Z + sum(yi * Ai for yi, Ai in zip(y, A)))
    b = np.asarray([float((Ai * X).sum()) for Ai in A])
    return SDP(C, A, b, X, y)


def write_dats(path: str, name: str, blocks: list, C: np.ndarray, A: list,
               b: np.ndarray) -> None:
    """SDPA sparse format: m, the number of blocks, their sizes, b, then the
    upper triangle of each block of C (matrix 0) and of A_1..A_m."""
    offsets = np.cumsum([0] + list(blocks[:-1]))
    with open(path, "w") as f:
        f.write(f'"{name}: an SDP made from a seed\n{len(A)}\n{len(blocks)}\n'
                + " ".join(str(k) for k in blocks) + "\n"
                + " ".join(repr(float(v)) for v in b) + "\n")
        for k, mat in enumerate([C] + list(A)):
            for blk, (off, nk) in enumerate(zip(offsets, blocks), 1):
                f.writelines(f"{k} {blk} {i + 1} {j + 1} {float(mat[off + i, off + j])!r}\n"
                             for i in range(nk) for j in range(i, nk) if mat[off + i, off + j])
