"""parallel/fused_prover.py, ``prove_zk`` over ``k`` shards on this
process's card, or over the ranks of the process group: the chain captured
as one CUDA graph a shape and replayed.  Zero-knowledge proofs."""

from __future__ import annotations

KEYS = ("k",)
VERIFIER = "verify"


def prover(traffic: dict, shape, device, group=None):
    from otti_tpu_torch.parallel import fused_prover as FP

    k = traffic["k"]
    where = {"group": group} if group is not None else {"devices": [device] * k}
    return lambda d, v, i, seed: FP.prove_zk(d, v, i, k=k, seed=seed, **where)
