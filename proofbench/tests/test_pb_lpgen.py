"""The LP generator: the published counts, every row and column covered,
feasible and bounded, the same LP from the same seed."""

import numpy as np
import pytest
from scipy.optimize import linprog

from proofbench import lpgen

SHAPES = {"lp-share1b": (117, 225, 957), "lp-25fv47": (821, 1571, 9556)}


@pytest.mark.parametrize("config", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_lp_has_the_published_shape_and_an_optimum(config, seed):
    m, n, nnz = SHAPES[config]
    A, b, c = lpgen.make_lp(m, n, nnz, seed, index=seed % 3)
    assert A.shape == (m, n) and np.count_nonzero(A) == nnz
    assert (A != 0).any(axis=1).all() and (A != 0).any(axis=0).all()
    assert set(np.unique(A[A != 0])) <= set(range(1, 10)) and (c < 0).all()
    res = linprog(c, A_ub=A, b_ub=b, bounds=(0, None), method="highs")
    assert res.status == 0  # feasible and bounded: an optimum


def test_same_seed_same_lp_other_index_other_lp():
    a = lpgen.make_lp(117, 225, 957, 5, 0)
    assert all(np.array_equal(x, y) for x, y in zip(a, lpgen.make_lp(117, 225, 957, 5, 0)))
    assert not np.array_equal(a[0], lpgen.make_lp(117, 225, 957, 5, 1)[0])


def test_too_few_nonzeros_refused():
    with pytest.raises(ValueError):
        lpgen.make_lp(10, 20, 19, 1)
