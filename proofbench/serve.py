"""The system under test: a proving service on one card (or one rank of a
process group) that holds a pool of lowered LP instances and proves one at
a time, one client in a closed loop.

Set-up lowers the pool with the program's own lowering (io.mps.parse_mps,
oracle.lp_oracle.solve, codegen.lp_cert.build), uploads
each instance (R1CSShape.to_device) and proves each once, which builds the
kernels, the comb tables and, on the captured route, the graph of the
pool's shape.  A request is one call of the traffic's route: it starts with
a lowered instance on the card and ends with the proof on the host.  The
pool is cycled in an order drawn from the seed, and request j's blinds come
from the seed and j.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import lpgen, routes
from . import trace as trace_mod


def log(msg: str) -> None:
    print(f"[proofbench] {msg}", file=sys.stderr, flush=True)


def lower(config: dict, seed: int, index: int, tmpdir: str) -> tuple:
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


def blind_seed(seed: int, j: int) -> bytes:
    return hashlib.sha256(b"proofbench blinds %d %d" % (seed, j)).digest()


def _ready(device) -> None:
    """The card's context and the kernel libraries (built at the first run
    of a checkout, loaded after)."""
    import torch

    from otti_tpu_torch import _build

    if device.type == "cuda":
        torch.cuda.init()
        _build.library()


@dataclasses.dataclass
class Instance:
    index: int
    shape: object
    vars: list
    inputs: list
    dev: object = None
    prove: object = None


class Server:
    """The pool on ``device`` (a card, or the CPU in tests), proved through
    the traffic's route; ``group`` is this rank's process group or None.
    ``tamper`` (control runs only) is applied to each witness after
    lowering."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, group=None,
                 tamper=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.group, self.tamper = device, group, tamper
        self.insts: list = []
        self.order = np.random.default_rng([seed % 2**64, 1 << 20]).permutation(config["pool"])
        self.j = 0  # requests made so far
        self.proofs: list = []  # (instance index, proof) of every request
        self.failed = 0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> dict:
        """Lower, upload and warm the pool; returns what it took.  The card's
        context and the kernel libraries are made on a thread while this one
        lowers (worker processes would each import torch, which takes longer
        than the lowering)."""
        pool, t0 = self.config["pool"], time.perf_counter()
        started = time.time()
        tmp = tempfile.mkdtemp(prefix="proofbench-")
        try:
            with ThreadPoolExecutor(1) as ex:
                ready = ex.submit(_ready, self.device)
                lowered = [lower(self.config, self.seed, i, tmp) for i in range(pool)]
                ready.result()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        t_lower = time.perf_counter() - t0
        for i, (shape, v, inp) in enumerate(lowered):
            if self.tamper is not None:
                v = self.tamper(i, v)
            self.insts.append(Instance(i, shape, v, inp))
        t1 = time.perf_counter()
        for inst in self.insts:
            inst.dev = inst.shape.to_device(self.device)
            inst.prove = routes.prover(self.traffic["route"], self.traffic, inst.shape,
                                       self.device, self.group)
        self._sync()
        t_upload = time.perf_counter() - t1
        t2 = time.perf_counter()
        for inst in self.insts:  # builds, captures, fills every cache of the pool
            inst.prove(inst.dev, inst.vars, inst.inputs, blind_seed(self.seed, -1 - inst.index))
        self._sync()
        info = {"started": started, "lower_s": t_lower, "upload_s": t_upload, "warm_s": time.perf_counter() - t2,
                "num_cons": sorted({s.shape.num_cons for s in self.insts}),
                "padded_cons": sorted({s.dev.num_cons for s in self.insts})}
        gc.collect()
        gc.freeze()  # the pool's Python objects stay out of the window's collections
        return info

    def request(self) -> dict:
        """One request: the next instance of the cycle, proved."""
        import torch
        from torch.profiler import record_function

        from otti_tpu_torch import metrics

        with record_function("request"):
            t0 = time.perf_counter()
            with record_function("pool_step"):
                j = self.j
                inst = self.insts[self.order[j % len(self.insts)]]
                seed = blind_seed(self.seed, j)
                self.j += 1
                metrics.reset()
            with record_function("prove_zk"):
                try:
                    proof = inst.prove(inst.dev, inst.vars, inst.inputs, seed)
                except (RuntimeError, ValueError, AssertionError, torch.cuda.OutOfMemoryError) as e:
                    log(f"request {j} on instance {inst.index} failed: {type(e).__name__}: {e}")
                    proof = None
            wall = time.perf_counter() - t0
        if proof is None:
            self.failed += 1
        else:
            self.proofs.append((inst.index, proof))
        return {"wall_s": wall, "ok": proof is not None, "counters": metrics.snapshot()}

    def _go_on(self, go: bool) -> bool:
        """Rank 0's decision, in a process group."""
        if self.group is None:
            return go
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(go)], device=self.device)
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag.item())

    def window(self, seconds: float) -> tuple:
        """Requests until ``seconds`` have passed, the last one finished:
        (records, window seconds)."""
        recs = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while self._go_on(time.perf_counter() < deadline):
            recs.append(self.request())
        return recs, time.perf_counter() - t0

    def traced(self, n: int) -> dict:
        """``n`` more requests under torch.profiler: trace.summarize's view."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        self._sync()
        with profile(activities=acts) as prof:
            for _ in range(n):
                self.request()
            self._sync()
        return trace_mod.summarize(*trace_mod.events(prof))

    def close(self) -> None:
        """Drop the program's state: graphs, instances, cached memory."""
        import torch

        from otti_tpu_torch.parallel import fused_prover

        fused_prover.clear_graphs()
        for inst in self.insts:
            inst.dev = inst.prove = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
