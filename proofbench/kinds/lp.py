"""LP optimality certificates: an LP made from the seed in the
configuration's Netlib shape (lpgen.py), lowered by the program from MPS
(io.mps.parse_mps, oracle.lp_oracle.solve, codegen.lp_cert.build) and by
the reference from the matrices (reference/lowering.py)."""

from __future__ import annotations

import os

from .. import lpgen
from ..reference import lowering

KEYS = ("rows", "cols", "nnz", "statement")


def program(config: dict, seed: int, index: int, tmpdir: str) -> tuple:
    """Instance ``index`` of the run: the LP made from the seed, written as
    MPS and lowered by the program.  Returns (R1CSShape, vars, inputs)."""
    from otti_tpu_torch.codegen import lp_cert
    from otti_tpu_torch.io import mps
    from otti_tpu_torch.oracle import lp_oracle

    A, b, c = lpgen.make_lp(config["rows"], config["cols"], config["nnz"], seed, index)
    path = os.path.join(tmpdir, f"{config['name']}-{index}.mps")
    lpgen.write_mps(path, f"{config['name']}-{index}", A, b, c)
    prob = mps.parse_mps(path)
    x, y, _ = lp_oracle.solve(prob)
    st = config["statement"]
    return lp_cert.build(prob, x, y, delta=st["delta"], cap_bits=st["cap_bits"])


def reference(config: dict, seed: int, index: int) -> lowering.R1CS:
    """The same instance's R1CS, worked out by the reference from the LP."""
    A, b, c = lpgen.make_lp(config["rows"], config["cols"], config["nnz"], seed, index)
    st = config["statement"]
    return lowering.lower(A, b, c, st["delta"], st["cap_bits"])
