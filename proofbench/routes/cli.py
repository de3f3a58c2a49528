"""The zk prover the CLI picks for the instance (``cli._provers``), as
``python -m otti_tpu_torch.cli`` calls it: fresh blinds every call, the
seed unused.  Zero-knowledge proofs."""

from __future__ import annotations

KEYS = ("k",)
VERIFIER = "verify"


def prover(traffic: dict, shape, device, group=None):
    from otti_tpu_torch import cli

    fn, _, _ = cli._provers(shape, True, "otti", traffic["k"], device, group)
    return lambda d, v, i, seed: fn(d, v, i)
