"""Multi-process bootstrap (port of otti_tpu/runtime.py::init_distributed).

The JAX package makes a pod run one logical JAX program: every host calls
``jax.distributed.initialize`` and ``jax.devices()`` then spans them all.
The port runs one process a card, joined by ``torch.distributed``: each
process is a rank, holds its card, and the sharded provers
(parallel/hybrid_sharded.py, parallel/sharded.py) exchange what crosses
ranks through the group.  The JAX module's compile cache and tunnel parts
have no counterpart here.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.rendezvous import rendezvous

# how long a rank waits for the others, at the rendezvous and in each
# collective, before it fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)

# what torch's launcher (torchrun) sets for every rank: the counterpart of
# the JAX package's COORDINATOR_ADDRESS check
_LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def host_ranks(store, rank: int, world: int) -> tuple:
    """(how many ranks of the group run on this host, this rank's index
    among them): every rank posts its host's name to the rendezvous
    ``store`` and reads every other's."""
    host = socket.gethostname()
    store.set(f"otti/host/{rank}", host)
    keys = [f"otti/host/{r}" for r in range(world)]
    store.wait(keys)
    here = [store.get(k).decode() == host for k in keys]
    return sum(here), sum(here[:rank])


def backend_for(device, ranks_on_host: int) -> str:
    """NCCL when every rank of this host has a card of its own, gloo when
    ranks share a card or run on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if ranks_on_host <= torch.cuda.device_count() else "gloo"


def init_distributed(coordinator: str | None = None, num_hosts: int | None = None,
                     host_id: int | None = None, device: str = "cuda") -> bool:
    """Join the process group of ``num_hosts`` ranks at ``coordinator``
    (host:port) as rank ``host_id``; a missing argument comes from the
    launcher's environment (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK).
    Returns False, doing nothing, when no argument is given and the
    environment holds no launcher config (a single process).

    The ranks count, at the rendezvous, how many of them share each host
    (``host_ranks``), and the backend follows ``backend_for``.  One process a
    card: on CUDA the rank's card, LOCAL_RANK if the launcher set it, else
    the rank's index among the ranks of its host, mod the visible cards,
    becomes the current device, so "cuda" means it from here on."""
    env = os.environ
    if (coordinator is None and num_hosts is None and host_id is None
            and not all(v in env for v in _LAUNCHER_ENV)):
        return False
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(env["WORLD_SIZE"]) if num_hosts is None else num_hosts
    rank = int(env["RANK"]) if host_id is None else host_id
    if not 0 <= rank < world:
        raise ValueError(f"host id {rank} is not a rank of a group of {world}")
    if torch.device(device).type == "cuda" and not torch.cuda.device_count():
        raise RuntimeError("a CUDA rank needs a visible card (pass --device cpu for the CPU)")
    store, rank, world = next(rendezvous(f"tcp://{coordinator}", rank, world, timeout=TIMEOUT))
    store.set_timeout(TIMEOUT)
    on_host, local = host_ranks(store, rank, world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", local)) % torch.cuda.device_count())
    dist.init_process_group(backend_for(device, on_host), store=store, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    return True
