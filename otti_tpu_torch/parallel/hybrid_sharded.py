"""Multi-device Spartan provers: k shards and one controller (port of
otti_tpu/parallel/hybrid_sharded.py).

The JAX package runs this prover as ``shard_map`` programs over a mesh of k
chips: one controller drives them, a sumcheck round costs one psum of 2-3
field scalars, and the transcript, the sigma arithmetic and the last rounds
are replicated on every chip.  The port is the same single-controller
design in eager torch.  One process holds k shards, each placed on a torch
device (``devices``: by default the first k cards; a device may hold
several shards).  Shards that share a device are stacked on a leading axis,
one shard group a device, in shard order, so that on one card a round is
one launch of kernel 2's batched entry over ``[k, n/k, 22]`` tables, as
``--batch`` uses it.  What the JAX package replicates runs once, on
``devices[0]`` (the controller): the transcript (K3), the round
commitments and their encodings (K4), the sigma arithmetic, the sums across
shards, the last log2(k) rounds and the opening; the bytes are the same.
Each round's challenge is copied to every shard device, where kernel 2
reads it from device memory; the groups' evaluations and survivors come
back to the controller by device-to-device copies.  Every kernel launch runs
on its tensors' card (csrc/device.cuh), so groups may sit on distinct cards.

Across processes (``group``: a ``torch.distributed`` process group of W
ranks, one process a card, as runtime.init_distributed makes it), rank r
holds the shards [r k/W, (r+1) k/W) on its own card and is its own
controller: every rank runs what the JAX package replicates on every chip
(the transcript, the encodings, the sigma arithmetic, the last log2(k)
rounds, the opening), so every rank ends with the proof.  What crosses
ranks goes through one exchange, ``all_gather`` in rank order, which is
shard order: a round's canonical partial evaluations (``_psum_canon``, then
the same pairwise canon tree, so every rank holds the same bits), the
survivors (``_Shards.gather``), the witness rows' encodings (``_commit``)
and the partial A~, B~, C~ (``_eval_at``).  In zero knowledge without a
given seed, rank 0 draws the blind seed and broadcasts it
(``_Shards.blind_seed``) before the blinds are drawn, or the replicated
controllers would draw different blinds; the JAX package has no such
broadcast.

Cyclic layout (as in the JAX package): logical index i = j*k + s lives on
shard s at local slot j, so the pair (i, i + n/2) that a round folds sits on
one shard, and the bound tables keep the layout.  The tables are made in
it, each shard's on its own device: eq as the eq table of the high
variables times a factor a shard (``_eq_shard_factor``), Az/Bz/Cz and the
phase-2 table from the COO entries grouped by row mod k and by column mod k
on the host (``partition_r1cs``).  A phase runs its log2(n/k) shard-local
rounds, each a kernel-2 launch a shard group and the field sum of the k
shards' evaluations on the controller (``_psum_canon``).  Once every shard
holds one element, the k survivors are gathered into ``[k, 22]`` tables
(shard s holds logical index s) and the single-device chain runs the last
log2(k) rounds (hybrid.py's phases, zkfused.py's zk rounds).  The JAX module
splits a phase into segments with a physical shrink of the tables between
them (``_seg_sharded``, ``_shrink_sharded``) to keep its compiled programs
small; eager torch compiles nothing, so a phase here is one loop, as in
hybrid.py.

Every absorbed byte is the single-device prover's, so the proofs are
byte-identical to hybrid.prove / hybrid.prove_zk (the same seed in zk),
and so to nizk.prove / zknizk.prove; the standard verifiers check them
(tests/test_torch_mesh.py).  As in hybrid.py, nothing waits on the card
between the witness commitment's fetch and the final packed fetch
(``OTTI_SYNC_CHECK=1`` holds it).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import metrics
from ..curve import ristretto
from ..field import ops as F
from ..field.fields import N_LIMBS, SCALAR
from ..msm import pippenger
from ..spartan import commitments, hybrid, mle, r1cs
from ..spartan.fused import assemble_plain_proof
from ..spartan.nizk import GENS_LABEL, PROTO, _hyrax_dims, _sb, _vec
from ..spartan.sumcheck_kernels import sumcheck_round
from ..transcript.device import POST_CHALLENGE
from ..transcript.merlin import Transcript

MOD = SCALAR.modulus
_CACHE_SIZE = 8  # instances whose partitions stay on the devices


# ---------------------------------------------------------------------------
# The helpers of otti_tpu/parallel/fused_prover.py
# ---------------------------------------------------------------------------

_PART_CACHE: dict = {}


# after otti_tpu/parallel/fused_prover.py::partition_r1cs
def partition_r1cs(dev: r1cs.R1CSDevice, k: int, device=None, shards=None) -> tuple:
    """Two COO copies of each matrix: grouped by row mod k (the phase-1
    products) and by column mod k (the phase-2 table), each shard's segment
    padded to a common length m (the longest of all k) with value-0
    entries.  Returns (by_row, by_col), each three (rows, cols, vals) with
    [len(shards)*m] int64 indices and [len(shards)*m, 22] int32 values on
    ``device`` (the instance's by default): the i-th of ``shards`` (all k
    by default) holds [i*m, (i+1)*m), by_row with local rows (row div k),
    by_col with local columns (column div k).  A rank of a process group
    builds only its own shards.  Cached for the last few instances."""
    device = dev.device if device is None else torch.device(device)
    shards = list(range(k)) if shards is None else list(shards)
    key = (dev.digest, dev.num_z, k, str(device), tuple(shards))
    if key in _PART_CACHE:
        return _PART_CACHE[key]

    def group(rows, cols, vals, by_col: bool):
        keyv = cols if by_col else rows
        m = max(int(np.bincount(keyv % k, minlength=k).max()), 1)
        R = np.zeros((len(shards), m), np.int64)
        C = np.zeros((len(shards), m), np.int64)
        V = np.zeros((len(shards), m, N_LIMBS), np.int32)
        for j, s in enumerate(shards):
            i = np.nonzero(keyv % k == s)[0]
            R[j, : len(i)] = rows[i] if by_col else rows[i] // k
            C[j, : len(i)] = cols[i] // k if by_col else cols[i]
            V[j, : len(i)] = vals[i]
        return tuple(torch.from_numpy(a.reshape((len(shards) * m,) + a.shape[2:])).to(device)
                     for a in (R, C, V))

    mats = [tuple(x.cpu().numpy() for x in mat) for mat in dev.mats]
    out = (tuple(group(*m, False) for m in mats), tuple(group(*m, True) for m in mats))
    while len(_PART_CACHE) >= _CACHE_SIZE:
        _PART_CACHE.pop(next(iter(_PART_CACHE)))
    _PART_CACHE[key] = out
    return out


# after otti_tpu/parallel/fused_prover.py::_eq_shard_factor
def _eq_shard_factor(tau_low: torch.Tensor, log_k: int, shards: list) -> torch.Tensor:
    """[len(shards), 22]: for each shard s, the product over the low
    variables of (tau_v if its bit of s is 1 else 1 - tau_v); tau_low[v]
    binds bit log_k-1-v of s.  The bits are known on the host, so each
    factor is a view picked in Python: no index tensor is uploaded."""
    dev = tau_low.device
    one_minus = F.sub(SCALAR, F.ones(SCALAR, (), dev), tau_low)
    acc = F.ones(SCALAR, (len(shards),), dev)
    for v in range(log_k):
        col = torch.stack([tau_low[v] if (s >> (log_k - 1 - v)) & 1 else one_minus[v]
                           for s in shards])
        acc = F.mul(SCALAR, acc, col)
    return acc


# after otti_tpu/parallel/fused_prover.py::_local_evals_raw
def _local_evals_raw(sh: "_Shards", tables: list, degree: int, r, prev_half):
    """Kernel 2 on every shard group (a launch a group): bind ``r`` into the
    active prefix of previous half ``prev_half`` (none in a phase's first
    round), then evaluate the round.  -> each group's [shards, 3 or 2, 22]
    evaluations (None after the bare final bind, prev_half == 1)."""
    return [sumcheck_round(tabs, degree, None if r is None else _to(r, d), prev_half)
            for (d, _), tabs in zip(sh.groups, tables)]


# after otti_tpu/parallel/fused_prover.py::_psum_canon
def _psum_canon(parts: list, sh: "_Shards") -> torch.Tensor:
    """Canonical field sum over the k shards (the leading axis of the
    groups' canonical parts, gathered across the ranks of a process group;
    k a power of two), on the controller: log2(k) levels of pairwise limb
    sums (< 2m), each made canonical by one batched canon, which for k up
    to 8 takes fewer torch ops than one wide reduction (a round's launches
    on the host are the prover's cost).  The parts are canonical, so every
    rank holds the same bits."""
    x = parts[0] if len(parts) == 1 else torch.cat([_to(p, sh.ctrl) for p in parts])
    x = sh.all_gather(x)
    while x.shape[0] > 1:
        x = F.canon(SCALAR, x[0::2] + x[1::2])
    return x[0]


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """What crosses the ranks of a process group, in one place: every rank's
    ``x`` (one shape on all), concatenated along the leading axis in rank
    order, back on x's device.  Gloo carries host tensors here: a CUDA
    tensor goes through host memory, copied there and back explicitly (the
    copy is the transport; the compute stays on the card).  NCCL takes the
    card's tensor as it is, on the current stream, with no host wait."""
    with hybrid._stage("exchange", x.device):
        wire = (x.cpu() if dist.get_backend(group) == "gloo" else x).contiguous()
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire, group=group)
        return _to(torch.cat(parts), x.device)


# ---------------------------------------------------------------------------
# Shards on devices
# ---------------------------------------------------------------------------

def _to(x: torch.Tensor, device) -> torch.Tensor:
    return x if x.device == device else x.to(device, non_blocking=True)


def _take(x: torch.Tensor, shards: list) -> torch.Tensor:
    """x[shards] along the leading (shard) axis: a view for a run of
    consecutive shards."""
    if shards == list(range(shards[0], shards[-1] + 1)):
        return x[shards[0] : shards[-1] + 1]
    return x[shards]


def _cat(local: list, tail: torch.Tensor) -> torch.Tensor:
    """A phase's local rounds' results followed by its tail's."""
    return torch.cat([torch.stack(local), tail]) if local else tail


class _Shards:
    """k shards on torch devices.  ``groups`` = [(device, shard ids)]: one a
    device, in the order the devices first appear, each with its shards in
    ascending order; the controller is ``devices[0]``, which must be the
    instance's device.  With a process ``group`` of W ranks, rank r holds
    the shards [r k/W, (r+1) k/W) on the instance's device (its card), and
    is its own controller."""

    def __init__(self, dev: r1cs.R1CSDevice, k: int | None, devices, group=None):
        self.group = group
        world = 1 if group is None else dist.get_world_size(group)
        if group is not None:
            if devices is not None:
                raise ValueError("in a process group each rank holds its shards on the "
                                 "instance's device: pass no devices")
            k = k or world
            if k % world:
                raise ValueError(f"{k} shards do not split over {world} ranks")
            devices = [dev.device] * (k // world)
        elif devices is None:
            visible = torch.cuda.device_count()
            k = k or visible
            if not k or visible < k:
                raise ValueError(f"{k or 'all'} shards need as many CUDA devices; {visible} "
                                 "visible (pass devices to place several shards on one)")
            devices = [torch.device("cuda", i) for i in range(k)]
        k = k or len(devices)
        if len(devices) * world != k:
            raise ValueError(f"{k} shards and {len(devices)} devices")
        if k & (k - 1):
            raise ValueError(f"the number of shards must be a power of two, got {k}")
        if dev.num_cons < k or dev.num_z < 2 * k:
            raise ValueError(f"instance too small for {k} shards: {dev.num_cons} padded "
                             f"constraints and {dev.num_z} z entries (k and 2k at least)")
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type != dev.device.type:
                raise ValueError(f"shard device {d} is not a {dev.device.type} device, as the "
                                 f"instance's {dev.device} is")
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if devs[0] != dev.device:
            raise ValueError(f"devices[0] ({devs[0]}) must be the instance's device "
                             f"({dev.device}): the controller")
        self.k, self.log_k, self.ctrl = k, k.bit_length() - 1, devs[0]
        first = (0 if group is None else dist.get_rank(group)) * len(devs)
        groups: dict = {}
        for s, d in enumerate(devs):
            groups.setdefault(d, []).append(first + s)
        self.groups = list(groups.items())
        order = [s - first for _, ss in self.groups for s in ss]
        # the gathered survivors come in group order: back to shard order
        self.unperm = (None if order == list(range(len(devs)))
                       else torch.tensor(np.argsort(order), device=self.ctrl))

    def put(self, x: torch.Tensor) -> list:
        """x (on the controller) on every group's device."""
        return [_to(x, d) for d, _ in self.groups]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This process's part (its shards in order on the leading axis) ->
        every rank's, in shard order (``all_gather``); x without a group."""
        return x if self.group is None else all_gather(x, self.group)

    def gather(self, tables: list) -> list:
        """Each table's element 0 of every shard -> [k, 22] on the
        controller, shard s at row s (its logical index)."""
        out = []
        for q in range(len(tables[0])):
            g = torch.cat([_to(tabs[q][:, 0, :], self.ctrl) for tabs in tables])
            out.append(self.all_gather(g if self.unperm is None
                                       else g.index_select(0, self.unperm)))
        return out

    def blind_seed(self) -> bytes:
        """A fresh 32-byte blind seed, the same on every rank: rank 0's,
        broadcast, so that the replicated controllers draw the same blinds."""
        seed = os.urandom(32)
        if self.group is None:
            return seed
        buf = torch.frombuffer(bytearray(seed), dtype=torch.uint8)
        if dist.get_backend(self.group) != "gloo":  # NCCL carries card tensors only
            buf = buf.to(self.ctrl)
        dist.broadcast(buf, dist.get_global_rank(self.group, 0), group=self.group)
        return bytes(buf.cpu().tolist())


def _group_parts(dev: r1cs.R1CSDevice, sh: _Shards) -> list:
    """Each shard group's entries from partition_r1cs, as three R1CSDevice
    on its device, so that R1CSDevice's own products give the group's
    tables: "row" (rows local to the group: the shard's place in it times
    n_cons/k plus row div k; global columns), "col" (global rows; local
    columns likewise) and "eval" (global rows j*k + s, global columns)."""
    k = sh.k
    nl1, nl2 = dev.num_cons // k, dev.num_z // k
    out = []
    for d, ss in sh.groups:
        by_row, by_col = partition_r1cs(dev, k, d, ss)
        place = torch.arange(len(ss), device=d)[:, None]
        sid = torch.tensor(ss, device=d)[:, None]

        def pick(x):
            return x.view((len(ss), -1) + tuple(x.shape[1:]))

        mats = {"row": [], "col": [], "eval": []}
        for (R, C, V), (Rc, Cc, Vc) in zip(by_row, by_col):
            R, C, V, Rc, Cc, Vc = map(pick, (R, C, V, Rc, Cc, Vc))
            V = V.reshape(-1, N_LIMBS)
            mats["row"].append(((R + place * nl1).reshape(-1), C.reshape(-1), V))
            mats["eval"].append(((R * k + sid).reshape(-1), C.reshape(-1), V))
            mats["col"].append((Rc.reshape(-1), (Cc + place * nl2).reshape(-1),
                                Vc.reshape(-1, N_LIMBS)))
        dims = {"row": (len(ss) * nl1, dev.num_z), "col": (dev.num_cons, len(ss) * nl2),
                "eval": (dev.num_cons, dev.num_z)}
        out.append({name: r1cs.R1CSDevice(num_cons=nc, num_z=nz, num_vars=dev.num_vars,
                                          num_inputs=dev.num_inputs, mats=tuple(mats[name]),
                                          digest=None)
                    for name, (nc, nz) in dims.items()})
    return out


# ---------------------------------------------------------------------------
# The sharded steps (the JAX module's _*_kernel functions)
# ---------------------------------------------------------------------------

def _commit_dev(sh: _Shards, w_flat, row_blinds, mu_rows: int, mu_cols: int) -> torch.Tensor:
    """The witness rows' Hyrax commitments, encoded by K4: [rows, 32] uint8
    on the controller, in row order, with no host wait.  Block-sharded when
    there are at least k rows (shard s commits rows [s, s+1) * rows/k on its
    device; in a process group every rank's rows come through
    ``all_gather``), else on the controller.  ``row_blinds`` [rows, 22] on
    the controller (zk) or None (plain)."""
    rows, cols = 1 << mu_rows, 1 << mu_cols
    zk = row_blinds is not None
    k, rl = sh.k, rows // sh.k
    W = w_flat.reshape(rows, cols, N_LIMBS)

    def encode(W_loc, rb, d):
        tbl = pippenger.fixed_base_tables(cols, GENS_LABEL, zk, d)
        if zk:
            from ..spartan.zkfused import _commit_rows_blinded

            return ristretto.encode(_commit_rows_blinded(_to(W_loc, d), _to(rb, d), tbl))
        return ristretto.encode(commitments.commit_rows(_to(W_loc, d), [0] * W_loc.shape[0],
                                                        GENS_LABEL, tbl=tbl))

    if rows < k:
        return encode(W, row_blinds, sh.ctrl)
    pieces = []  # (shard, its rows' encodings on the controller)
    for d, ss in sh.groups:
        W_loc = _take(W.view(k, rl, cols, N_LIMBS), ss).reshape(-1, cols, N_LIMBS)
        rb = None if not zk else _take(row_blinds.view(k, rl, N_LIMBS), ss).reshape(-1, N_LIMBS)
        got = encode(W_loc, rb, d).view(len(ss), rl, 32)
        pieces += [(s, _to(got[j], sh.ctrl)) for j, s in enumerate(ss)]
    return sh.all_gather(torch.cat([p for _, p in sorted(pieces, key=lambda x: x[0])]))


def _commit(sh: _Shards, w_flat, row_blinds, mu_rows: int, mu_cols: int) -> list:
    """``_commit_dev``'s encodings fetched to the host (transfer 1), as the
    rows' 32-byte strings."""
    return [bytes(row.tobytes()) for row in _commit_dev(sh, w_flat, row_blinds, mu_rows,
                                                         mu_cols).cpu().numpy()]


def _tables1(sh: _Shards, taus: list, zs: list, parts: list, num_cons: int) -> list:
    """Each group's [eq, Az, Bz, Cz], [shards, n_cons/k, 22] in the cyclic
    layout: eq of the high variables times each shard's factor, and the
    products over the group's row partition."""
    log_k = sh.log_k
    mu_x = (num_cons - 1).bit_length()
    out = []
    for (_, ss), tau, z, part in zip(sh.groups, taus, zs, parts):
        eq_hi = mle.eq_table(tau[: mu_x - log_k])
        fac = _eq_shard_factor(tau[mu_x - log_k :], log_k, ss)
        abc = part["row"].matvecs(z)
        out.append([F.mul(SCALAR, eq_hi[None], fac[:, None])]
                   + [x.view(len(ss), -1, N_LIMBS) for x in abc])
    return out


def _mtable(sh: _Shards, rabc, e_rx, parts: list) -> list:
    """Each group's phase-2 table [shards, num_z/k, 22] over its column
    partition."""
    return [part["col"].matvec_T_weighted(_to(rabc, d).unbind(-2), _to(e_rx, d))
            .view(len(ss), -1, N_LIMBS) for (d, ss), part in zip(sh.groups, parts)]


def _eval_at(sh: _Shards, e_rx, e_ry, parts: list) -> torch.Tensor:
    """A~, B~, C~ at (rx, ry), [3, 22] canonical: each group's sums over its
    row partition at global rows, summed over the groups on the controller
    (once a prove: one wide reduction), then over the ranks of a process
    group (``_psum_canon``)."""
    sums = [_to(torch.stack(part["eval"].eval_at(_to(e_rx, d), _to(e_ry, d))), sh.ctrl)
            for (d, _), part in zip(sh.groups, parts)]
    return _psum_canon([F.canon(SCALAR, F.sum_reduce(SCALAR, torch.stack(sums), axis=0))[None]],
                       sh)


def _local_rounds(sh: _Shards, tables: list, degree: int, step) -> tuple:
    """The log2(n/k) shard-local rounds of a phase: kernel 2 on every group,
    the shards' evaluations summed on the controller, then ``step(evals,
    j)`` (the round's absorbs, or the zk round) returns the challenge,
    which the next launch binds; the last bind is bare.  Returns (the
    number of local rounds, the gathered [k, 22] tables)."""
    n_local = tables[0][0].shape[-2]
    rounds = n_local.bit_length() - 1
    r = None
    for j in range(rounds):
        half = None if r is None else n_local >> j
        r = step(_psum_canon(_local_evals_raw(sh, tables, degree, r, half), sh), j)
    if rounds:
        _local_evals_raw(sh, tables, degree, r, 1)
    return rounds, sh.gather(tables)


def _local_phase(sh: _Shards, t, tables: list, degree: int, label: bytes) -> tuple:
    """The local plain rounds: each absorbs its evaluations and squeezes r
    (fused._round_scan's transcript steps).  Returns (evals list, r list,
    gathered tables)."""
    labels = [label + b"/e%d" % p for p in ((0, 2, 3) if degree == 3 else (0, 2))]
    evals_l, rs = [], []

    def step(evals, _):
        assert t.strobe.offsets == POST_CHALLENGE, "round not at the post-challenge offsets"
        for i, lbl in enumerate(labels):
            t.append_scalar_limbs(lbl, evals[i])
        evals_l.append(evals)
        rs.append(t.challenge_scalar_limbs(label + b"/r"))
        return rs[-1]

    _, gathered = _local_rounds(sh, tables, degree, step)
    return evals_l, rs, gathered


def _zk_phase(sh: _Shards, t, tables: list, blinds: tuple, tbl: dict, e, be, label: bytes,
              degree: int) -> tuple:
    """A zk phase: the local rounds (zkfused._zk_round_from_evals on the
    summed evaluations, with the first log2(n/k) rows of the blinds), then
    zkfused._zk_round_scan on the gathered tables with the rest.  Returns
    (e, be, encs, z, zdb, rs, gathered tables)."""
    from ..spartan.zkfused import _zk_round_from_evals, _zk_round_scan

    carry = [e, be]
    outs = ([], [], [], [])  # encs, z, zdb, r of each local round

    def step(evals, j):
        e2, b2, r, enc, zz, zdb = _zk_round_from_evals(
            label, degree, tbl, t, carry[0], carry[1], evals, tuple(b[j] for b in blinds))
        carry[:] = [e2, b2]
        for lst, x in zip(outs, (enc, zz, zdb, r)):
            lst.append(x)
        return r

    n_loc, gathered = _local_rounds(sh, tables, degree, step)
    e, be, *tail = _zk_round_scan(t, label, degree, tbl, gathered,
                                  tuple(b[n_loc:] for b in blinds), *carry)
    return (e, be) + tuple(_cat(lo, ta) for lo, ta in zip(outs, tail)) + (gathered,)


# ---------------------------------------------------------------------------
# The provers
# ---------------------------------------------------------------------------

def _place(sh: _Shards, z: torch.Tensor) -> tuple:
    """z (on the controller) on every group's device, and each group's
    cyclic slice of it, [shards, num_z/k, 22] (z[j*k + s]; a copy, which
    phase 2 binds in place)."""
    zt = z.view(z.shape[0] // sh.k, sh.k, N_LIMBS).transpose(0, 1)
    return sh.put(z), [_take(zt, ss).to(d).clone(memory_format=torch.contiguous_format)
                       for d, ss in sh.groups]


def _setup(sh: _Shards, dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list):
    """Uploads before the chain: the witness w [nvp, 22] and z on the
    controller, z on every group's device, each group's cyclic z slice
    (``_place``) and its partition entries."""
    nvp = dev.num_vars
    w = _vec(list(vars_ints) + [0] * (nvp - len(vars_ints)), sh.ctrl)
    z = r1cs.assemble_z(w, _vec(inputs_ints, sh.ctrl) if inputs_ints else None, nvp)
    zs, z_loc = _place(sh, z)
    return w, zs, z_loc, _group_parts(dev, sh)


def _start(t: Transcript, dev: r1cs.R1CSDevice, inputs_ints: list) -> Transcript:
    t.append_message(b"R1CS", dev.digest)
    t.append_u64(b"num_inputs", len(inputs_ints))
    for x in inputs_ints:
        t.append_scalar(b"input", _sb(x))
    metrics.add("constraints", dev.num_cons)
    metrics.add("msm_points", dev.num_vars)
    return t


def _plain_chain(sh: _Shards, td, tau, w, zs: list, z_loc: list, parts: list, num_cons: int,
                 mu_rows: int, mu_cols: int) -> list:
    """From tau ([mu_x, 22] on the controller) to the opening materials,
    with ``td`` at the post-challenge offsets and no host wait.  Returns
    [rounds1, vabc, rounds2, u, claim_w] on the controller."""
    taus = sh.put(tau)
    with hybrid._stage("matvecs", sh.ctrl):
        t1 = _tables1(sh, taus, zs, parts, num_cons)
    r1_l, rx_l, g1 = _local_phase(sh, td, t1, 3, b"sc1")
    r1_t, rx_t, vabc, rabc = hybrid._phase1(td, *g1)
    rxs = _cat(rx_l, rx_t)
    with hybrid._stage("m_table", sh.ctrl):
        m = _mtable(sh, rabc, mle.eq_table(rxs), parts)
    r2_l, ry_l, g2 = _local_phase(sh, td, [list(x) for x in zip(m, z_loc)], 2, b"sc2")
    r2_t, ry_t = hybrid._phase2(td, *g2)
    u, claim_w = hybrid._opening(w, _cat(ry_l, ry_t), mu_rows, mu_cols)
    return [_cat(r1_l, r1_t), vabc, _cat(r2_l, r2_t), u, claim_w]


def _zk_chain(sh: _Shards, td, tau, w, zs: list, z_loc: list, parts: list, blinds: tuple,
              tbls: tuple, num_cons: int, mu_rows: int, mu_cols: int) -> dict:
    """The same in zero knowledge: ``blinds`` = (row_blinds, sc1, abc, prod,
    eq1_a, sc2) on the controller (hybrid._zk_uploads of one instance),
    ``tbls`` the comb tables of the sc1 rounds, the mid section and the sc2
    rounds.  Returns hybrid._zk_device_chain's materials by name."""
    ctrl = sh.ctrl
    row_blinds, sc1, abc, prod, eq1_a, sc2 = blinds
    tbl_sc1, tbl_mid, tbl_sc2 = tbls
    taus = sh.put(tau)
    with hybrid._stage("matvecs", ctrl):
        t1 = _tables1(sh, taus, zs, parts, num_cons)
    with hybrid._stage("zk_phase1", ctrl):
        zero = F.zeros((), ctrl)
        e1, be1, sc1_encs, sc1_z, sc1_zdb, rxs, g1 = _zk_phase(
            sh, td, t1, sc1, tbl_sc1, zero, zero, b"sc1", 3)
        vabc = F.canon(SCALAR, torch.stack([tb[0] for tb in g1[1:]]))
    with hybrid._stage("zk_mid", ctrl):
        mid_encs, mid_z, rabc, claim2, bclaim2 = hybrid._zk_mid(
            td, tau, rxs, vabc, abc, prod, eq1_a, e1, be1, tbl_mid)
    e_rx = mle.eq_table(rxs)
    with hybrid._stage("m_table", ctrl):
        m = _mtable(sh, rabc, e_rx, parts)
    with hybrid._stage("zk_phase2", ctrl):
        e2, be2, sc2_encs, sc2_z, sc2_zdb, rys, _ = _zk_phase(
            sh, td, [list(x) for x in zip(m, z_loc)], sc2, tbl_sc2, claim2, bclaim2,
            b"sc2", 2)
    with hybrid._stage("eval_at", ctrl):
        eabc = _eval_at(sh, e_rx, mle.eq_table(rys), parts)
    with hybrid._stage("opening", ctrl):
        u, buwv = hybrid._zk_opening(w, row_blinds, rys, eabc, rabc, mu_rows, mu_cols)
    e2b = F.canon(SCALAR, torch.stack([e2, be2]))
    return dict(state2=td.strobe.state, sc1_encs=sc1_encs, sc1_z=sc1_z, sc1_zdb=sc1_zdb,
                mid_encs=mid_encs, mid_z=mid_z, sc2_encs=sc2_encs, sc2_z=sc2_z,
                sc2_zdb=sc2_zdb, u=u, tail_vals=torch.cat([buwv, e2b]), rys=rys)


def _zk_tables(ctrl) -> tuple:
    """The comb tables of the zk rounds and of the mid section on ``ctrl``."""
    from ..spartan.zkfused import _mid_tables, _round_tables

    return _round_tables(3, ctrl), _mid_tables(ctrl), _round_tables(2, ctrl)


@torch.inference_mode()
def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list, k: int = None,
          proto: bytes = None, devices=None, group=None):
    """The plain NIZK over k shards (``devices``: one torch device a shard,
    by default cuda:0 .. cuda:k-1; k defaults to len(devices), else to the
    visible cards; or, with a process ``group``, k/W shards a rank on the
    instance's device, k defaulting to W): byte-identical to hybrid.prove
    and nizk.prove, on every rank."""
    sh = _Shards(dev, k, devices, group)
    mu_rows, mu_cols = _hyrax_dims(dev.num_vars)
    mu_x = (dev.num_cons - 1).bit_length()
    t = _start(Transcript(proto or PROTO), dev, inputs_ints)
    w, zs, z_loc, parts = _setup(sh, dev, vars_ints, inputs_ints)
    with metrics.timed("commit"):  # fetches the row encodings: host time is device time
        comm_enc = _commit(sh, w, None, mu_rows, mu_cols)
    t2 = hybrid._fork(t)  # the pristine transcript replays in the host tail
    for enc in comm_enc:
        t2.append_point(b"poly_commitment", enc)
    tau = t2.challenge_vector(b"challenge_tau", mu_x)

    with metrics.timed("device_chain"), hybrid._stage_times():
        td = hybrid._check_handoff([t2], sh.ctrl)
        tau_c = _vec(tau, sh.ctrl)
        with hybrid._no_host_sync(sh.ctrl):
            mats = _plain_chain(sh, td, tau_c, w, zs, z_loc, parts, dev.num_cons, mu_rows,
                                mu_cols)
        got, _ = hybrid._fetch_packed(mats, [])
    metrics.add("sumcheck_rounds", mu_x)
    with metrics.timed("host_tail"):
        return assemble_plain_proof(t, comm_enc, *got, mu_x, mu_rows, mu_cols)


@torch.inference_mode()
def prove_zk(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list, k: int = None,
             seed: bytes = None, devices=None, group=None):
    """The zk NIZK over k shards (``devices``, ``k`` and ``group`` as in
    ``prove``): byte-identical to hybrid.prove_zk and zknizk.prove with the
    same blind seed.  In a process group the seed, if none is given, is
    rank 0's (``_Shards.blind_seed``)."""
    from ..spartan.pedersen_host import BlindSource
    from ..spartan.zkfused import assemble_zk_proof
    from ..spartan.zknizk import PROTO as ZK_PROTO

    sh = _Shards(dev, k, devices, group)
    ctrl = sh.ctrl
    rng = BlindSource(seed or sh.blind_seed())
    mu_rows, mu_cols = _hyrax_dims(dev.num_vars)
    mu_x = (dev.num_cons - 1).bit_length()
    with metrics.timed("blinds"):  # zknizk.prove's order
        _, *blinds = hybrid._first(hybrid._zk_uploads([rng], dev, mu_rows))
    t = _start(Transcript(ZK_PROTO), dev, inputs_ints)
    w, zs, z_loc, parts = _setup(sh, dev, vars_ints, inputs_ints)
    with metrics.timed("commit"):  # fetches the row encodings: host time is device time
        comm_enc = _commit(sh, w, blinds[0], mu_rows, mu_cols)
    for enc in comm_enc:
        t.append_point(b"poly_commitment", enc)
    tau = t.challenge_vector(b"challenge_tau", mu_x)

    with metrics.timed("device_chain"), hybrid._stage_times():
        td = hybrid._check_handoff([t], ctrl)
        tau_c = _vec(tau, ctrl)
        tbls = _zk_tables(ctrl)
        with hybrid._no_host_sync(ctrl):
            out = _zk_chain(sh, td, tau_c, w, zs, z_loc, parts, tuple(blinds), tbls,
                            dev.num_cons, mu_rows, mu_cols)
        with metrics.timed("fetch"):
            got = hybrid._fetch_zk(out)
    metrics.add("sumcheck_rounds", mu_x)
    with metrics.timed("host_tail"):
        return assemble_zk_proof(dev, rng, comm_enc, got)
