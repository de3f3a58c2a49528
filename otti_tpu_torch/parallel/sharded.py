"""Sharded hot loops: a sumcheck round, its bind, the MSM and the sparse
matvec over shards (port of otti_tpu/parallel/sharded.py).

The JAX module lays an array's leading axis over the "sp" axis of a
``jax.sharding.Mesh`` (block layout: shard s holds rows [s n/sp, (s+1)
n/sp)) and runs each function as a ``shard_map`` program.  Here a mesh is a
small object (``Mesh``): the devices of the shards this process holds, in
shard order (several may share a device), and optionally a
``torch.distributed`` process group, whose rank r holds the shards [r L,
(r+1) L) of L a rank.  A sharded array is the list of this process's
blocks, one a shard, each on its shard's device (``shard`` cuts one from a
whole tensor, ``unshard`` puts the blocks of every rank back together).

Each function is shard-local work plus one exchange: the round's three
canonical partial sums and the matvec's partial products are summed over
the shards (gathered across ranks by ``hybrid_sharded.all_gather``, the
exchange of the sharded provers), and the MSM's per-shard partial points
are gathered and tree-added (``edwards.sum_points``).  As in the JAX module
the round binds LSB first (pairs (2j, 2j+1)), unlike the provers' MSB-first
convention.  Every result is on the first shard's device, the same on
every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..curve import edwards as E
from ..field import ops as F
from ..field.fields import N_LIMBS, SCALAR
from ..msm import pippenger
from ..spartan import r1cs
from .hybrid_sharded import all_gather


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: the devices of this process's shards, in shard order;
    ``group``: the process group whose rank r holds the shards [r L, (r+1)
    L), L = len(devices), or None."""

    devices: tuple
    group: object = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def sp(self) -> int:
        """The number of shards over all ranks."""
        return len(self.devices) * self.world

    @property
    def first(self) -> int:
        """The first shard this process holds."""
        return 0 if self.group is None else dist.get_rank(self.group) * len(self.devices)

    @property
    def ctrl(self) -> torch.device:
        return self.devices[0]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This process's part -> every rank's, in rank order (x without a
        group)."""
        return x if self.group is None else all_gather(x, self.group)


def make_mesh(n_devices: int | None = None, dp: int = 1, device="cuda", group=None) -> Mesh:
    """The "sp" axis of the JAX module's (dp, sp) mesh of ``n_devices``:
    sp = n_devices / dp shards (the port keeps no "dp" axis: nothing
    replicates over it).  Without a group the shards go over the
    visible cards (the one CPU for ``device="cpu"``), one a card while
    there are enough, else in blocks, and ``n_devices`` defaults to their
    number; with a process group of W ranks
    it defaults to W, and each rank holds sp / W shards on ``device`` (its
    card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is not None:
        world = dist.get_world_size(group)
        sp = (n_devices or world) // dp
        if sp % world:
            raise ValueError(f"{sp} shards do not split over {world} ranks")
        return Mesh(tuple([device] * (sp // world)), group)
    visible = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    sp = (n_devices or len(visible)) // dp
    if not sp:
        raise ValueError("a mesh needs a device")
    per = -(-sp // len(visible))  # shards a device: the first sp devices, or blocks of shards
    return Mesh(tuple(visible[s // per] for s in range(sp)))


def shard(mesh: Mesh, x: torch.Tensor) -> list:
    """This process's blocks of x's leading axis (n divisible by sp), each on
    its shard's device."""
    blocks = x.chunk(mesh.sp)
    if len(blocks) != mesh.sp or x.shape[0] % mesh.sp:
        raise ValueError(f"{x.shape[0]} rows do not split into {mesh.sp} shards")
    return [blocks[mesh.first + i].to(d) for i, d in enumerate(mesh.devices)]


def unshard(mesh: Mesh, parts: list) -> torch.Tensor:
    """Every shard's block in shard order, on the first device: the whole
    array."""
    return mesh.all_gather(torch.cat([p.to(mesh.ctrl) for p in parts]))


def _psum(mesh: Mesh, parts: list) -> torch.Tensor:
    """Canonical field sum over the shards of each shard's part (leading
    axis one a local shard): the local parts, then every rank's."""
    x = mesh.all_gather(torch.stack([p.to(mesh.ctrl) for p in parts]))
    return F.canon(SCALAR, F.sum_reduce(SCALAR, x, axis=0))


# ---------------------------------------------------------------------------
# Sharded sumcheck round (cubic, phase-1 shape)
# ---------------------------------------------------------------------------

def _ext_lsb(tbl: torch.Tensor, t: int) -> torch.Tensor:
    """Bind the LSB variable at X = t: pairs (2j, 2j+1) -> lo + t (hi - lo)."""
    lo, hi = tbl[0::2], tbl[1::2]
    if t == 0:
        return lo
    return F.add(SCALAR, lo, F.mul_small(SCALAR, F.sub(SCALAR, hi, lo), t))


def round_cubic_sharded(mesh: Mesh, eq: list, pa: list, pb: list, pc: list) -> tuple:
    """One sumcheck round over sharded tables (blocks [n/sp, 22]): (e0, e2,
    e3), canonical [22] each, sum over the pairs of eq(t) (A(t) B(t) - C(t))
    at t = 0, 2, 3.  The table math is shard-local; one sum of three
    scalars over the shards."""
    parts = []
    for q in zip(eq, pa, pb, pc):
        outs = []
        for t in (0, 2, 3):
            eqt, at, bt, ct = (_ext_lsb(x, t) for x in q)
            outs.append(F.dot(SCALAR, eqt, F.sub(SCALAR, F.mul(SCALAR, at, bt), ct)))
        parts.append(torch.stack(outs))
    return tuple(_psum(mesh, parts))


def bind_sharded(mesh: Mesh, r: torch.Tensor, *tables: list) -> tuple:
    """Bind the LSB variable to the challenge r ([22]) on every shard:
    each sharded table -> lo + r (hi - lo), sharded."""
    out = []
    for tbl in tables:
        out.append([F.add(SCALAR, lo, F.mul(SCALAR, F.sub(SCALAR, hi, lo), r.to(lo.device)))
                    for lo, hi in ((x[0::2], x[1::2]) for x in tbl)])
    return tuple(out)


# ---------------------------------------------------------------------------
# Sharded MSM
# ---------------------------------------------------------------------------

def msm_sharded(mesh: Mesh, points: list, scalars: list, window: int = 4) -> dict:
    """Pippenger with the points sharded: each shard runs the whole windowed
    bucket algorithm (``pippenger.msm``) on its block and gives one partial
    point; the sp partials are gathered and tree-added (log2(sp) batched
    adds).  ``points``: one point batch (dict) a shard."""
    partials = [pippenger.msm(p, s, window=window) for p, s in zip(points, scalars)]
    stacked = torch.stack([torch.stack([q[c] for c in E.COORDS]).to(mesh.ctrl)
                           for q in partials])  # [L, 4, 22]
    gathered = mesh.all_gather(stacked)
    return E.sum_points(E.pt(*gathered.unbind(1)))


# ---------------------------------------------------------------------------
# Sharded sparse matvec (Az/Bz/Cz with the nonzeros over the shards)
# ---------------------------------------------------------------------------

def matvec_sharded(mesh: Mesh, rows: list, cols: list, vals: list, z: torch.Tensor,
                   num_cons: int) -> torch.Tensor:
    """rows/cols/vals (COO entries) sharded, z [num_z, 22] replicated: a
    local gather, multiply and int64 segment sum a shard (R1CSDevice's
    ``index_add_`` and ``reduce_wide``), then one sum of the [num_cons, 22]
    partials over the shards.  -> [num_cons, 22] canonical."""
    parts = []
    for r, c, v in zip(rows, cols, vals):
        zl = z.to(v.device)
        prods = F.mul(SCALAR, v.reshape(-1, N_LIMBS), zl[c])
        parts.append(r1cs.R1CSDevice._segment_sum(prods, r, (), num_cons))
    return _psum(mesh, parts)
