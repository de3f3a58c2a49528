"""Run one cell of BENCHMARK.json:

    python3 -m proofbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (everything up to the window, from this process's first line)
lowers and warms the pool; the window runs requests for ``--seconds``,
the last one to its end; with ``--trace 1`` the window is followed by the
traffic's ``trace_requests`` requests under torch.profiler, and the line
carries the per-layer metrics instead of the end-to-end ones.  Then the
program's state is freed and the reference judges the run (judge.py).  The
last lines of standard error give each number compared beside its limit;
the last line of standard output is the result.  No card, too few cards,
or jax, jaxlib, flax or otti_tpu loaded: a message, no result, exit 2 or 3.
"""

import time

T0 = time.time()  # set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "otti_tpu")
EXIT_NO_CHIP, EXIT_JAX = 2, 3


def jax_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def chips_missing(chips: int) -> str:
    """Why this machine cannot run a cell of ``chips`` cards, or ''."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA card is visible"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible"
    return ""


def metric_values(cell, folder: str, record: dict) -> dict:
    """{name: {value, unit}} of the cell's metrics in ``folder``
    ("end_to_end" or "layer_metrics") whose reader finds something."""
    out = {}
    for m in cell.end_to_end if folder == "end_to_end" else cell.per_layer:
        v = cell.reader(folder, m["name"])(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(cell, record: dict, trace: bool, checks: dict, device: dict) -> dict:
    """The result line; ``checks`` is {name: (value, limit)}."""
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": len(record["requests"]),
           "failed": sum(not r["ok"] for r in record["requests"]),
           "metrics": metric_values(cell, "layer_metrics" if trace else "end_to_end", record),
           "device": device}
    tr = record.get("trace")
    if trace and tr and tr.get("requests"):
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def emit(res: dict) -> int:
    """The check lines (last on standard error) and the result line (last on
    standard output); exit 3 instead where a JAX module is loaded."""
    found = jax_modules()
    if found:
        print(f"[proofbench] modules of jax or the JAX package are loaded: {found}",
              file=sys.stderr, flush=True)
        return EXIT_JAX
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


def run_single(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0,
               workers: int = None, fault: str = None) -> dict:
    """One process, one card (or the CPU in tests): the result line.
    ``fault`` (faults.py) is for the control and the tests alone."""
    import torch

    from otti_tpu_torch.spartan import serial

    from . import faults, judge, serve

    workers = workers or os.cpu_count() or 1
    tamper = faults.plant(fault, seed) if fault else None
    server = serve.Server(cell, seed, device, tamper=tamper)
    info = server.setup()
    record = {"setup_s": time.time() - t0}
    _log_setup(serve, info, record["setup_s"], t0)
    record["requests"], record["window_s"] = server.window(seconds)
    t1 = time.time()
    record["trace"] = server.traced(cell.traffic["trace_requests"]) if trace else None
    if trace:
        serve.log(f"traced {cell.traffic['trace_requests']} requests and read the trace in "
                  f"{time.time() - t1:.3f}s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    insts, proofs, failed = server.insts, server.proofs, server.failed
    server.close()
    t1 = time.time()
    checks = judge.judge(cell, seed, insts, proofs, failed, workers, serial.dumps)
    serve.log(f"the reference judged the run in {time.time() - t1:.3f}s")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return result(cell, record, trace, checks,
                  {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak})


def _log_setup(serve, info: dict, setup_s: float, t0: float) -> None:
    from otti_tpu_torch.parallel import fused_prover

    graphs = fused_prover.graphs()
    serve.log(f"set-up {setup_s:.3f}s: imports and start {info['started'] - t0:.3f}s, lowering "
              f"{info['lower_s']:.3f}s, upload "
              f"{info['upload_s']:.3f}s, warm {info['warm_s']:.3f}s; constraints "
              f"{info['num_cons']}, padded {info['padded_cons']}; {len(graphs)} graph(s): "
              + json.dumps([{k: g[k] for k in ("num_cons", "k", "warmup_s", "capture_s",
                                               "pool_mib")} for g in graphs]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from . import cell as cell_mod

    cell = cell_mod.load(args.workload)
    why = chips_missing(cell.chips)
    if why:
        print(f"[proofbench] {why}: no result", file=sys.stderr)
        return EXIT_NO_CHIP
    if cell.traffic["ranks"] > 1:
        from . import ranks

        return ranks.launch(cell, args.seed, args.seconds, bool(args.trace))
    import torch

    res = run_single(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    return emit(res)


if __name__ == "__main__":
    sys.exit(main())
