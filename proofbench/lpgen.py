"""LPs made from a seed in a Netlib instance's published shape.

After chip_smoke.py::write_lp_mps: min c x with A x <= b, x >= 0 and no
BOUNDS section.  A >= 0 holds integers 1-9 at exactly ``nnz`` places,
every row and every column covered, b = A x0 + slack for an integer
x0 >= 0 and c < 0: feasible (x0) and bounded (every x_j <= b_i / a_ij), so
the LP oracle's row duals close the duality gap.
"""

from __future__ import annotations

import numpy as np


def make_lp(rows: int, cols: int, nnz: int, seed: int, index: int = 0) -> tuple:
    """(A, b, c) of instance ``index`` of the run seeded ``seed``."""
    if not max(rows, cols) <= nnz <= rows * cols:
        raise ValueError(f"{nnz} nonzeros cannot cover a {rows} x {cols} matrix")
    rng = np.random.default_rng([seed % 2**64, index])
    A = np.zeros((rows, cols))
    cover = max(rows, cols)
    r, c = rng.permutation(rows), rng.permutation(cols)
    A[r[np.arange(cover) % rows], c[np.arange(cover) % cols]] = rng.integers(1, 10, size=cover)
    free = np.flatnonzero(A == 0)
    extra = nnz - cover
    A.flat[rng.choice(free, size=extra, replace=False)] = rng.integers(1, 10, size=extra)
    b = A @ rng.integers(0, 5, size=cols) + rng.integers(0, 4, size=rows)
    c = -rng.integers(1, 10, size=cols).astype(float)
    return A, b.astype(float), c


def write_mps(path: str, name: str, A: np.ndarray, b: np.ndarray, c: np.ndarray) -> None:
    """Free-format MPS: rows R<i> of sense L, columns X<j>, objective COST."""
    m, n = A.shape
    with open(path, "w") as f:
        f.write(f"NAME {name}\nROWS\n N  COST\n")
        f.writelines(f" L  R{i}\n" for i in range(m))
        f.write("COLUMNS\n")
        for j in range(n):
            f.write(f"    X{j} COST {float(c[j])!r}\n")
            f.writelines(f"    X{j} R{i} {float(A[i, j])!r}\n" for i in np.flatnonzero(A[:, j]))
        f.write("RHS\n")
        f.writelines(f"    RHS R{i} {float(b[i])!r}\n" for i in range(m))
        f.write("ENDATA\n")
