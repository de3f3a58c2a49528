# copied from otti_tpu/io/sdpa.py
"""SDPA sparse-format (.dat-s) parser (replaces the reference's smcp dep).

Parses the SDPLIB instances shipped with the reference
(datasets/SDP/{small,full}).  Semantics follow sdpcodegen.parse_problem_file
(SURVEY.md §2.1 SDP codegen row): block-diagonal matrices are densified
into full n x n symmetric matrices; matrix 0 is the objective C, matrices
1..m are the constraints A_i with right-hand sides b.

SDPA sparse format:
  <comment lines starting with " or *>
  m
  nblocks
  <block sizes, negative = diagonal block>
  b_1 ... b_m
  <matno> <blkno> <i> <j> <value>     (1-based, upper triangle)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SDPProblem:
    name: str
    n: int  # total matrix dimension
    m: int  # number of constraints
    C: np.ndarray  # [n, n]
    A: list  # m matrices [n, n]
    b: np.ndarray  # [m]


def parse_dats(path: str, name: str | None = None) -> SDPProblem:
    tokens_lines = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith('"') or line.startswith("*"):
                continue
            tokens_lines.append(line)

    def next_numbers(line):
        out = []
        for tok in (
            line.replace(",", " ")
            .replace("{", " ")
            .replace("}", " ")
            .replace("(", " ")
            .replace(")", " ")
            .split()
        ):
            try:
                out.append(float(tok))
            except ValueError:
                continue  # annotations like "=mdim" in SDPLIB headers
        return out

    m = int(next_numbers(tokens_lines[0])[0])
    nblocks = int(next_numbers(tokens_lines[1])[0])
    block_sizes = [int(v) for v in next_numbers(tokens_lines[2])[:nblocks]]
    b = np.asarray(next_numbers(tokens_lines[3])[:m])

    dims = [abs(s) for s in block_sizes]
    n = sum(dims)
    offsets = np.cumsum([0] + dims[:-1])

    C = np.zeros((n, n))
    A = [np.zeros((n, n)) for _ in range(m)]
    for line in tokens_lines[4:]:
        vals = next_numbers(line)
        if len(vals) < 5:
            continue
        matno, blkno, i, j, v = (
            int(vals[0]),
            int(vals[1]),
            int(vals[2]),
            int(vals[3]),
            float(vals[4]),
        )
        off = offsets[blkno - 1]
        r, c = off + i - 1, off + j - 1
        tgt = C if matno == 0 else A[matno - 1]
        tgt[r, c] = v
        tgt[c, r] = v

    return SDPProblem(
        name=name or path.rsplit("/", 1)[-1], n=n, m=m, C=C, A=A, b=b
    )


def random_problem(m: int, n: int, seed: int = 0) -> tuple:
    """Random strictly-feasible SDP with known interior point (the unit-test
    fixture the reference left disabled, sdpcodegen.py:67-75)."""
    rng = np.random.default_rng(seed)
    A = []
    for _ in range(m):
        r = rng.uniform(-1, 1, size=(n, n))
        A.append(0.5 * (r + r.T))
    Xr = rng.uniform(-1, 1, size=(n, n))
    X = Xr.T @ Xr + np.eye(n)
    b = np.asarray([float((X * Ai).sum()) for Ai in A])
    Cr = rng.uniform(-1, 1, size=(n, n))
    C = 0.5 * (Cr + Cr.T)
    return SDPProblem("random", n, m, C, A, b), X
