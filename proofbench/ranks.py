"""One process a card: the launcher of a cell whose traffic has ranks > 1,
and the rank each child process runs.

The launcher picks a free local port, starts ``ranks`` children (``python3
-m proofbench.ranks``) with torchrun's variables (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK), and waits.  Each rank joins the group
(runtime.init_distributed: NCCL, a card a rank), sets up the same pool,
and proves every request with the others; rank 0 decides when the window
ends.  After the window the ranks gather their proofs' digests, memory
peaks and traces on rank 0, drop their graphs (NCCL's teardown waits on a
graph that holds its collectives), leave the group, and rank 0 has the
reference judge the run and writes the result, which the launcher prints.
A child that fails, or a run past its time, ends every child and the run
with ``correct`` false.  Each rank gathers its own loaded modules of jax,
jaxlib, flax or otti_tpu with its digests; where any rank holds one, every
rank exits 3 and the launcher prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

TIMEOUT_S = 330  # a run's whole time, set-up and judging included


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(rank: int, world: int, port: int) -> dict:
    return dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def launch(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
           t0: float = None, timeout: float = TIMEOUT_S, fault: str = None) -> int:
    """Run the ranks; print the result line (``correct`` false where a rank
    failed).  Returns the exit code.  ``device`` "cpu" (gloo) and ``fault``
    (faults.py) are for the tests and the control alone."""
    from .run import EXIT_JAX, T0, emit

    t0 = T0 if t0 is None else t0
    world = cell.traffic["ranks"]
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="proofbench-ranks-")
    out = os.path.join(tmp, "result.json")
    spec = json.dumps({"workload": cell.name, "root": cell.root, "seed": seed,
                       "seconds": seconds, "trace": trace, "device": device, "t0": t0,
                       "out": out, "fault": fault})
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-m", "proofbench.ranks", spec],
                                          env=child_env(r, world, port), stdout=f,
                                          stderr=subprocess.STDOUT, cwd=cell.root))
    deadline = time.time() + timeout
    bad = []
    while any(p.poll() is None for p in procs):
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if bad or time.time() > deadline:
            break
        time.sleep(0.2)
    for p in procs:  # a failed rank leaves the others waiting in a collective
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in range(world):
        print(f"---- rank {r} (exit {procs[r].returncode}) ----\n{_tail(logs[r])}",
              file=sys.stderr)
    jax = [r for r, p in enumerate(procs) if p.returncode == EXIT_JAX]
    if jax:
        print(f"[proofbench] ranks {jax} loaded modules of jax or the JAX package: no result",
              file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)
        return EXIT_JAX
    if bad or not os.path.exists(out):
        print(f"[proofbench] ranks {bad or 'all'} failed or ran out of time", file=sys.stderr)
        res = {"correct": False, "attempted": 0, "failed": 1, "metrics": {},
               "device": {"platform": "gpu", "kind": "unknown", "count": world,
                          "memory_peak_bytes": 0},
               "checks": {"ranks_failed": {"value": len(bad) or world, "limit": 0}}}
        emit(res)
        shutil.rmtree(tmp, ignore_errors=True)
        return 1
    with open(out) as f:
        res = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return emit(res)


def _digest(proof) -> str:
    from otti_tpu_torch.spartan import serial

    return hashlib.sha256(serial.dumps(proof).encode()).hexdigest()


def child(spec: dict) -> int:
    """One rank of the run."""
    import torch
    import torch.distributed as dist

    from otti_tpu_torch import runtime
    from otti_tpu_torch.spartan import serial

    from . import cell as cell_mod
    from . import faults, judge, run, serve

    cell = cell_mod.load(spec["workload"], spec["root"])
    tamper = faults.plant(spec["fault"], spec["seed"]) if spec["fault"] else None
    runtime.init_distributed(device=spec["device"])
    group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device()) if spec["device"] == "cuda"
              else torch.device("cpu"))
    server = serve.Server(cell.config, cell.traffic, spec["seed"], device, group, tamper)
    info = server.setup()
    record = {"setup_s": time.time() - spec["t0"]}
    if rank == 0:
        run._log_setup(serve, info, record["setup_s"], spec["t0"])
    record["requests"], record["window_s"] = server.window(spec["seconds"])
    tr = server.traced(cell.traffic["trace_requests"]) if spec["trace"] else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    mine = {"digests": [_digest(p) for _, p in server.proofs], "peak": peak, "trace": tr,
            "jax": run.jax_modules()}
    every = [None] * world
    dist.all_gather_object(every, mine, group=group)
    insts, proofs, failed = server.insts, server.proofs, server.failed
    server.close()
    dist.barrier(group)
    dist.destroy_process_group()
    found = {r: e["jax"] for r, e in enumerate(every) if e["jax"]}
    now = run.jax_modules()  # also what the teardown loaded
    if now:
        found[rank] = now
    if found:  # every rank refuses; the launcher then prints no result
        print(f"[proofbench] modules of jax or the JAX package loaded, by rank: {found}",
              file=sys.stderr)
        return run.EXIT_JAX
    if rank:
        return 0
    if tr and tr.get("requests"):  # device time averaged over the cards
        tr = dict(tr, busy_s=sum(e["trace"]["busy_s"] for e in every) / world,
                  launches=sum(e["trace"]["launches"] for e in every) / world)
    record["trace"] = tr
    checks = judge.judge(cell.config, spec["seed"], insts, proofs, failed, os.cpu_count() or 1,
                         serial.dumps)
    agree = sum(len({e["digests"][j] if j < len(e["digests"]) else None for e in every}) > 1
                for j in range(len(mine["digests"])))
    checks = {**checks, "ranks_disagreeing": (agree, 0)}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    res = run.result(cell, record, spec["trace"], checks,
                     {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                      "count": world, "memory_peak_bytes": max(e["peak"] for e in every)})
    found = run.jax_modules()
    if found:  # loaded while judging
        print(f"[proofbench] rank 0 loaded modules of jax or the JAX package: {found}",
              file=sys.stderr)
        return run.EXIT_JAX
    with open(spec["out"], "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(child(json.loads(sys.argv[1])))
