"""The program's entries a traffic mix can name as its ``route``, one file a
route: ``routes/<route>.py``, which cell.load loads by its path.  A route
file gives

- ``KEYS``: the traffic keys it reads beyond ``route``, ``ranks`` and
  ``trace_requests``;
- ``prover(traffic, shape, device, group) -> prove``: for one lowered
  instance, ``prove(dev, vars, inputs, seed)``, one request's proof by
  otti_tpu_torch (the program imported inside the body alone);
- ``VERIFIER``: the name of the module under ``reference/`` whose
  ``verify(r1cs, inputs, proof_json) -> bool`` checks its proofs.
"""

from __future__ import annotations


def prover(cell, shape, device, group=None):
    """``prove(dev, vars, inputs, seed)`` of the cell's route for one
    lowered instance on ``device``; ``group`` is this rank's process group
    or None."""
    return cell.route.prover(cell.traffic, shape, device, group)
