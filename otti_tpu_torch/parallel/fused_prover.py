"""Single-dispatch sharded Spartan provers (port of
otti_tpu/parallel/fused_prover.py).

The JAX module runs the whole sharded prover (the witness commitment, both
sumcheck phases with the transcript, the opening materials) as one XLA
program over a mesh of k chips, with the transcript on the device from the
first absorb to the last squeeze and one fetch at the end.  Here the same
chain is one stretch of device work with no host round trip between the
uploads and the single fetch, and PyTorch's counterpart of one program, one
dispatch is a CUDA graph: where every shard of this process sits on one
card (k shards on one card, or one rank's shards in an NCCL group), the
chain is captured once for each shape key and replayed after that.

The host absorbs the instance into the transcript (hybrid_sharded._start),
exports the sponge (its state becomes a device input, its offsets part of
the key), assembles z and partitions the matrices by row and column mod k
(hybrid_sharded.partition_r1cs).  The device part, ``_core`` and
``_zk_core``, then runs what the JAX module's ``_core`` / ``_zk_core``
kernels run: the shard-local Hyrax row commitments, gathered in shard order
and encoded by K4 (hybrid_sharded._commit_dev), absorbed on the device
transcript, tau squeezed there, and from tau on the chain of
hybrid_sharded.py (``_plain_chain`` / ``_zk_chain``: the local rounds, a
canonical sum across shards, the gathered survivors' tail rounds, the
phase-2 table, the opening; in zero knowledge every round's commitments and
sigma arithmetic, zkfused._mid_zk).  One packed fetch (hybrid._fetch_packed
/ _fetch_zk) and the host assembly (fused.assemble_plain_proof,
zkfused.assemble_zk_proof) follow.  hybrid_sharded.py differs only in where
the transcript meets the host: it fetches the row encodings and squeezes tau
there, which is the JAX package's segmented prover.

The capture.  ``captures`` decides from the configuration alone: CUDA, one
card for this process's shards, and no process group or an NCCL one.
Shards on distinct cards of one process (a torch graph belongs to one
device) and gloo groups (their exchanges stage through host memory) run
the same core uncaptured, and so does the CPU.  A graph is keyed by
``_key``: zk or plain, the padded sizes, every partition tensor's shape
(the nnz of each shard part, padded to a power of two by value-0 entries,
``_padded``, so that the instances of one padded class share a graph), the
strobe's offsets, k, the devices and the group.  Before each replay the static inputs (the strobe state, z, every
blind, the partitioned rows, columns and values) are filled with ``copy_``;
the static outputs are the fetch's tensors.  Before the capture one eager
run on the capture stream fills every lazy cache the chain reads (the comb
tables, the transcript's constant bytes, the field and curve constants,
kernel 2's scratch and ticket for that stream, each kernel library's
per-device set-up), so that the capture allocates only from its own pool
and uploads nothing.  Nothing taken from the witness, a blind or a
challenge reaches a kernel or an op as a Python value: kernel 2 reads its
challenge from device memory.  A capture or replay error raises; nothing
falls back to the uncaptured core.  A captured launch's own error check
runs only at capture, so a replay's errors surface at the fetch, whose copy
to the host synchronises the stream.

What a prove leaves in ``metrics``: the host spans ``blinds`` (zk),
``transcript``, ``inputs``, ``submit``, ``fetch`` (both inside
``device_chain``) and ``host_tail``, each also a torch.profiler range while
a profiler records; and, read from CUDA events once the fetch has
synchronised the stream, ``graph_device_s`` (the replay, timed on its
stream) and each ``hybrid._stage``'s ``<stage>_dev_s`` (``commit``: the rows
absorbed and tau; then the chain's stages; ``exchange`` over ranks).  A
captured graph records its stages' events as event-record nodes, which
every replay records again; nothing waits on the card for them.

Every absorbed byte is the single-device prover's, so the proofs are
byte-identical to fused.prove / nizk.prove and, with the same blind seed,
zknizk.prove (tests/test_torch_fused_prover.py).
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from .. import _build, metrics
from ..spartan import hybrid, r1cs
from ..spartan.fused import assemble_plain_proof
from ..spartan.nizk import PROTO, _hyrax_dims, _vec
from ..transcript.device import DeviceStrobe, DeviceTranscript, export_host_strobe
from ..transcript.merlin import Transcript
from . import hybrid_sharded as hs

_CACHE_SIZE = 8  # captured graphs kept; each holds its memory pool
_GRAPHS: dict = {}  # _key -> _Graph
_STREAMS: dict = {}  # device -> the stream every graph of it is captured and replayed on


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def captures(devices, group=None) -> bool:
    """Whether a prove whose shards of this process sit on ``devices`` runs
    its core as a captured CUDA graph: all on one CUDA card, and no process
    group or an NCCL one."""
    devs = {_device(d) for d in devices}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        return False
    return group is None or dist.get_backend(group) == "nccl"


@dataclasses.dataclass
class _Graph:
    """One captured core: the graph, its static inputs and outputs, and what
    its capture cost."""

    graph: torch.cuda.CUDAGraph
    inputs: dict
    outputs: tuple
    warmup_s: float  # the eager run on the capture stream
    capture_s: float  # capture and instantiation
    pool_mib: float  # device memory the graph's pool reserved
    launches: dict  # kernel launches captured into the graph, by wrapper
    stages: list  # hybrid._stage's (name, start, end) events, recorded by every replay
    replays: int = 0


def _leaves(x) -> list:
    """The tensors of an input tree (dicts by key, lists, tuples, R1CSDevice
    by its matrices) in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, r1cs.R1CSDevice):
        return _leaves(x.mats)
    if isinstance(x, dict):
        return [leaf for key in sorted(x) for leaf in _leaves(x[key])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    raise TypeError(f"not an input of the core: {type(x)}")


def _clone(x):
    """The same tree with every tensor copied (the graph's static inputs:
    the partitions of a prove are views of a cache)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, r1cs.R1CSDevice):
        return dataclasses.replace(x, mats=_clone(x.mats))
    if isinstance(x, dict):
        return {key: _clone(v) for key, v in x.items()}
    return type(x)(_clone(v) for v in x)


def _key(zk: bool, sh: hs._Shards, dev: r1cs.R1CSDevice, offsets: tuple, inputs: dict) -> tuple:
    return (zk, dev.num_cons, dev.num_z, dev.num_vars,
            tuple(tuple(x.shape) for x in _leaves(inputs["parts"])), offsets, sh.k,
            tuple((str(d), tuple(ss)) for d, ss in sh.groups),
            None if sh.group is None else id(sh.group))


def _stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _capture(core, inputs: dict, device: torch.device) -> _Graph:
    """The eager warm-up on the capture stream, then the capture; the
    current stream is the capture stream."""
    static = _clone(inputs)
    t0 = time.perf_counter()
    with hybrid._no_host_sync(device):
        core(static)
    torch.cuda.synchronize(device)
    warmup_s = time.perf_counter() - t0
    before = dict(_build.LAUNCHES)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    # thread_local: another thread's CUDA calls (NCCL's watchdog, the CLI's
    # lowering thread) may not end this thread's capture
    with torch.cuda.graph(graph, stream=_stream(device), capture_error_mode="thread_local"):
        with hybrid._collect() as stages:
            outputs = core(static)
    torch.cuda.synchronize(device)
    return _Graph(graph=graph, inputs=static, outputs=outputs, warmup_s=warmup_s,
                  capture_s=time.perf_counter() - t0,
                  pool_mib=(torch.cuda.memory_reserved(device) - reserved) / 2**20,
                  launches={n: c - before[n] for n, c in _build.LAUNCHES.items()},
                  stages=stages)


def _run(zk: bool, sh: hs._Shards, dev: r1cs.R1CSDevice, offsets: tuple, core, inputs: dict,
         fetch):
    """``fetch(core(inputs))``: captured and replayed where ``captures``
    says so, else eagerly; no host sync before the fetch.  Spans: ``submit``
    (the core's launches, or the static inputs' copies and the replay's
    launch), ``fetch``; counters: the graph's device time
    (``graph_device_s``) and its stages' (``<stage>_dev_s``), read from CUDA
    events once the fetch has synchronised the stream."""
    ctrl = sh.ctrl
    if not captures([d for d, _ in sh.groups], sh.group):
        with hybrid._stage_times():
            with metrics.timed("submit"), hybrid._no_host_sync(ctrl):
                out = core(inputs)
            with metrics.timed("fetch"):
                return fetch(out)
    with metrics.timed("submit"):
        key = _key(zk, sh, dev, offsets, inputs)
        g = _GRAPHS.get(key)
        s = _stream(ctrl)
        with torch.cuda.device(ctrl):
            s.wait_stream(torch.cuda.current_stream(ctrl))  # the inputs' uploads
            with torch.cuda.stream(s):
                if g is None:
                    with metrics.timed("graph_capture"):
                        g = _capture(core, inputs, ctrl)
                    while len(_GRAPHS) >= _CACHE_SIZE:
                        _GRAPHS.pop(next(iter(_GRAPHS)))
                    _GRAPHS[key] = g
                else:
                    for dst, src in zip(_leaves(g.inputs), _leaves(inputs)):
                        dst.copy_(src)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record(s)
                g.graph.replay()
                end.record(s)
    g.replays += 1
    metrics.add("graph_replays")
    with metrics.timed("fetch"), torch.cuda.device(ctrl), torch.cuda.stream(s):
        out = fetch(g.outputs)  # synchronises the stream: a replay's errors raise here
    metrics.add("graph_device_s", start.elapsed_time(end) / 1e3)
    hybrid._add_stage_times(g.stages)
    return out


def graphs() -> list:
    """What each cached graph cost: its key's sizes, warm-up, capture and
    instantiation seconds, pool MiB, captured launches and replays."""
    return [dict(zk=key[0], num_cons=key[1], num_z=key[2], k=key[6], warmup_s=g.warmup_s,
                 capture_s=g.capture_s, pool_mib=g.pool_mib, launches=dict(g.launches),
                 replays=g.replays) for key, g in _GRAPHS.items()]


def clear_graphs() -> None:
    """Drop every cached graph (and with it its memory pool).  Call it
    before destroying a process group whose collectives a graph captured:
    NCCL's teardown waits for every graph that holds them."""
    _GRAPHS.clear()


def _inputs(sh: hs._Shards, dev: r1cs.R1CSDevice, t: Transcript, vars_ints: list,
            inputs_ints: list) -> tuple:
    """The core's inputs on the controller: the sponge state, z and the
    shard groups' partitions (hybrid_sharded._group_parts); and the
    sponge's offsets."""
    st, *offsets = export_host_strobe(t.strobe)
    nvp = dev.num_vars
    z = r1cs.assemble_z(_vec(list(vars_ints) + [0] * (nvp - len(vars_ints)), sh.ctrl),
                        _vec(inputs_ints, sh.ctrl) if inputs_ints else None, nvp)
    parts = [{name: _padded(p) for name, p in group.items()}
             for group in hs._group_parts(dev, sh)]
    return {"state": torch.from_numpy(st).to(sh.ctrl), "z": z, "parts": parts}, tuple(offsets)


def _padded(part: r1cs.R1CSDevice) -> r1cs.R1CSDevice:
    """``part`` with each matrix's entries padded to a power of two by
    value-0 entries at (0, 0), which add nothing to any product: instances
    of one padded class, whose shard parts differ by a few entries, then
    share a graph."""
    mats = []
    for rows, cols, vals in part.mats:
        pad = (1 << (rows.shape[0] - 1).bit_length()) - rows.shape[0]
        mats.append((torch.cat([rows, rows.new_zeros(pad)]), torch.cat([cols, cols.new_zeros(pad)]),
                     torch.cat([vals, vals.new_zeros((pad,) + tuple(vals.shape[1:]))])))
    return dataclasses.replace(part, mats=tuple(mats))


def _absorb_rows(sh: hs._Shards, inputs: dict, offsets: tuple, num_vars: int, row_blinds):
    """The device part up to tau: the host transcript continued on the
    controller from the state input, the witness rows committed (blinded in
    zk), encoded and absorbed.  Returns (transcript, w, row encodings)."""
    mu_rows, mu_cols = _hyrax_dims(num_vars)
    w = inputs["z"][:num_vars]
    td = DeviceTranscript(_strobe=DeviceStrobe.from_state(inputs["state"], *offsets))
    enc = hs._commit_dev(sh, w, row_blinds, mu_rows, mu_cols)
    for i in range(1 << mu_rows):
        td.append_message(b"poly_commitment", enc[i])
    return td, w, enc


def _core(sh: hs._Shards, num_cons: int, num_vars: int, offsets: tuple, inputs: dict) -> tuple:
    """The plain prover on the device (fused_prover.py::_core): rows, tau,
    hybrid_sharded._plain_chain.  Returns (materials, [row encodings])."""
    mu_rows, mu_cols = _hyrax_dims(num_vars)
    with hybrid._stage("commit", sh.ctrl):
        td, w, enc = _absorb_rows(sh, inputs, offsets, num_vars, None)
        tau = td.challenge_vector_limbs(b"challenge_tau", (num_cons - 1).bit_length())
    zs, z_loc = hs._place(sh, inputs["z"])
    return hs._plain_chain(sh, td, tau, w, zs, z_loc, inputs["parts"], num_cons, mu_rows,
                           mu_cols), [enc]


def _zk_core(sh: hs._Shards, num_cons: int, num_vars: int, offsets: tuple, tbls: tuple,
             inputs: dict) -> tuple:
    """The zk prover on the device (fused_prover.py::_zk_core): blinded
    rows, tau, hybrid_sharded._zk_chain.  Returns (materials, (row
    encodings,))."""
    mu_rows, mu_cols = _hyrax_dims(num_vars)
    blinds = inputs["blinds"]
    with hybrid._stage("commit", sh.ctrl):
        td, w, enc = _absorb_rows(sh, inputs, offsets, num_vars, blinds[0])
        tau = td.challenge_vector_limbs(b"challenge_tau", (num_cons - 1).bit_length())
    zs, z_loc = hs._place(sh, inputs["z"])
    return hs._zk_chain(sh, td, tau, w, zs, z_loc, inputs["parts"], blinds, tbls, num_cons,
                        mu_rows, mu_cols), (enc,)


@torch.inference_mode()
def prove(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list, k: int = None,
          proto: bytes = None, devices=None, group=None):
    """The plain NIZK over k shards in one device chain (``k``, ``devices``
    and ``group`` as in hybrid_sharded.prove): byte-identical to fused.prove
    and nizk.prove, on every rank."""
    with metrics.timed("inputs"):
        sh = hs._Shards(dev, k, devices, group)
    mu_rows, mu_cols = _hyrax_dims(dev.num_vars)
    mu_x = (dev.num_cons - 1).bit_length()
    with metrics.timed("transcript"):
        t = hs._start(Transcript(proto or PROTO), dev, inputs_ints)
    with metrics.timed("inputs"):
        inputs, offsets = _inputs(sh, dev, t, vars_ints, inputs_ints)

    def core(ins):
        return _core(sh, dev.num_cons, dev.num_vars, offsets, ins)

    with metrics.timed("device_chain"):
        (r1, vabc, r2, u, cw), (enc,) = _run(
            False, sh, dev, offsets, core, inputs, lambda out: hybrid._fetch_packed(*out))
    metrics.add("sumcheck_rounds", mu_x)
    with metrics.timed("host_tail"):
        return assemble_plain_proof(t, [bytes(row.tobytes()) for row in enc], r1, vabc, r2, u,
                                    cw, mu_x, mu_rows, mu_cols)


@torch.inference_mode()
def prove_zk(dev: r1cs.R1CSDevice, vars_ints: list, inputs_ints: list, k: int = None,
             seed: bytes = None, devices=None, group=None):
    """The zk NIZK over k shards in one device chain (``k``, ``devices`` and
    ``group`` as in ``prove``): byte-identical to zknizk.prove with the same
    blind seed.  In a process group the seed, if none is given, is rank 0's
    (hybrid_sharded._Shards.blind_seed)."""
    from ..spartan.pedersen_host import BlindSource
    from ..spartan.zkfused import assemble_zk_proof
    from ..spartan.zknizk import PROTO as ZK_PROTO

    with metrics.timed("inputs"):
        sh = hs._Shards(dev, k, devices, group)
    rng = BlindSource(seed or sh.blind_seed())
    with metrics.timed("blinds"):  # zknizk.prove's order
        _, *blinds = hybrid._first(hybrid._zk_uploads([rng], dev, _hyrax_dims(dev.num_vars)[0]))
    with metrics.timed("transcript"):
        t = hs._start(Transcript(ZK_PROTO), dev, inputs_ints)
    with metrics.timed("inputs"):
        inputs, offsets = _inputs(sh, dev, t, vars_ints, inputs_ints)
        inputs["blinds"] = tuple(blinds)
        tbls = hs._zk_tables(sh.ctrl)

    def core(ins):
        return _zk_core(sh, dev.num_cons, dev.num_vars, offsets, tbls, ins)

    with metrics.timed("device_chain"):
        got = _run(True, sh, dev, offsets, core, inputs,
                   lambda out: hybrid._fetch_zk(out[0], out[1]))
    metrics.add("sumcheck_rounds", (dev.num_cons - 1).bit_length())
    with metrics.timed("host_tail"):
        return assemble_zk_proof(dev, rng, [bytes(row.tobytes()) for row in got["extra"][0]],
                                 got)
