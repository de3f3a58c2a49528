"""Dense multilinear-polynomial helpers (port of otti_tpu/spartan/mle.py).

A dense MLE over mu variables is a ``[2^mu, 22]`` table of its values on
the Boolean hypercube; bit (mu-1-j) of the row index is variable j, so
variable 0 is the MSB of the index (Spartan's front-first binding).
"""

from __future__ import annotations

import torch

from ..field.fields import SCALAR

from ..field import ops as F


def eq_table(r_limbs: torch.Tensor) -> torch.Tensor:
    """[..., mu, 22] challenges -> [..., 2^mu, 22] tables of eq(r, x) (semi
    form); a leading batch axis gives one table an instance, in the same
    launches as one table."""
    lead = tuple(r_limbs.shape[:-2])
    tbl = F.ones(SCALAR, lead + (1,), r_limbs.device).contiguous()
    for j in range(r_limbs.shape[-2]):
        # r_j is [1, 22] (one table: a shared operand) or [B, 1, 22]
        hi = F.mul(SCALAR, tbl, r_limbs[..., j : j + 1, :])
        lo = F.sub(SCALAR, tbl, hi)  # tbl * (1 - r_j)
        # new index = old index * 2 + x_j: interleave lo / hi
        tbl = torch.stack([lo, hi], dim=-2).reshape(lead + (-1, lo.shape[-1]))
    return tbl


def evaluate(poly: torch.Tensor, r_limbs: torch.Tensor) -> torch.Tensor:
    """Evaluate a [2^mu, 22] MLE at the point r ([mu, 22]) -> [22]."""
    return F.dot(SCALAR, eq_table(r_limbs), poly, axis=0)
