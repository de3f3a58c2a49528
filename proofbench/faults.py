"""Faults planted under the timed path, for the control and the tests that
show ``correct`` coming out false; the benchmark's own runs plant none.

- ``witness`` (the control): every instance's witness off by one in one
  variable drawn from the seed, so the program proves a statement that is
  false; the configuration's guarantee says no such proof verifies.
- ``answer``: each proof altered where it is produced (the host tail's
  bullet.z1 plus one).
- ``exchange``: the exchange between ranks left out (each rank takes its
  own part for every rank's).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reference.lowering import MOD

FAULTS = ("witness", "answer", "exchange")


def plant(fault: str, seed: int):
    """Patch the program for ``fault``; returns the witness tamper for
    serve.Server, or None."""
    if fault == "witness":
        def tamper(index: int, witness: list) -> list:
            j = int(np.random.default_rng([seed % 2**64, index, 3 << 20]).integers(len(witness)))
            return witness[:j] + [(witness[j] + 1) % MOD] + witness[j + 1:]
        return tamper
    if fault == "answer":
        from otti_tpu_torch.spartan import zkfused

        assemble = zkfused.assemble_zk_proof

        def altered(*args, **kw):
            proof = assemble(*args, **kw)
            return dataclasses.replace(proof, bullet=dataclasses.replace(
                proof.bullet, z1=(proof.bullet.z1 + 1) % MOD))
        zkfused.assemble_zk_proof = altered
        return None
    if fault == "exchange":
        import torch
        import torch.distributed as dist

        from otti_tpu_torch.parallel import hybrid_sharded

        hybrid_sharded.all_gather = lambda x, group: torch.cat([x] * dist.get_world_size(group))
        return None
    raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
