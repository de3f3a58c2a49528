"""SDP optimality certificates: an SDP made from the seed in the
configuration's SDPLIB shape (sdpgen.py), lowered by the program from its
SDPA sparse file (``cli.lower_sdp``: io.sdpa.parse_dats,
oracle.sdp_oracle.solve and cholesky_witness, codegen.sdp_cert.build) and by
the reference from the matrices (reference/sdp_lowering.py)."""

from __future__ import annotations

import os

from .. import sdpgen
from ..reference import lowering, sdp_lowering

KEYS = ("m", "blocks", "statement")


def _instance(config: dict, seed: int, index: int) -> sdpgen.SDP:
    return sdpgen.make_sdp(config["m"], config["blocks"], seed, index)


def program(config: dict, seed: int, index: int, tmpdir: str) -> tuple:
    """Instance ``index`` of the run: the SDP made from the seed, written as
    SDPA sparse and lowered by the program.  Returns (R1CSShape, vars,
    inputs)."""
    from otti_tpu_torch import cli

    sdp = _instance(config, seed, index)
    name = f"{config['name']}-{index}"
    path = os.path.join(tmpdir, name + ".dat-s")
    sdpgen.write_dats(path, name, config["blocks"], sdp.C, sdp.A, sdp.b)
    shape, vars_, inputs, _ = cli.lower_sdp(path, epsilon=config["statement"]["epsilon"])
    return shape, vars_, inputs


def reference(config: dict, seed: int, index: int) -> lowering.R1CS:
    """The same instance's R1CS, worked out by the reference from the SDP."""
    sdp = _instance(config, seed, index)
    st = config["statement"]
    return sdp_lowering.lower(sdp.C, sdp.A, sdp.b, st["epsilon"], st["cap_bits"])
