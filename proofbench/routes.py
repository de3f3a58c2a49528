"""The program's entries a traffic mix can name as its ``route``.

A route turns one lowered instance into ``prove(dev, vars, inputs, seed)``,
one request's zero-knowledge proof by otti_tpu_torch (the reference's
verifier checks the zk NIZK only):

- ``fused_prover``: parallel/fused_prover.py, ``prove_zk`` over ``k``
  shards on this process's card, or over the ranks of the process group:
  the chain captured as one CUDA graph a shape and replayed.
- ``cli``: the zk prover the CLI picks for the instance (``cli._provers``),
  as ``python -m otti_tpu_torch.cli`` calls it: fresh blinds every call,
  the seed unused.
"""

from __future__ import annotations


def prover(route: str, traffic: dict, shape, device, group=None):
    if route == "fused_prover":
        from otti_tpu_torch.parallel import fused_prover as FP

        k = traffic["k"]
        where = {"group": group} if group is not None else {"devices": [device] * k}
        return lambda d, v, i, seed: FP.prove_zk(d, v, i, k=k, seed=seed, **where)
    if route == "cli":
        from otti_tpu_torch import cli

        fn, _, _ = cli._provers(shape, True, "otti", traffic["k"], device, group)
        return lambda d, v, i, seed: fn(d, v, i)
    raise ValueError(f"no route {route!r}")
