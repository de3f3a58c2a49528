"""Command line and SGD run functions of the port (port of otti_tpu/cli.py).

    python -m otti_tpu_torch.cli --sgd --transparent [--small|--full|--config F]
                                 [--device cuda|cpu] [--out DIR]

Per instance: fetch the dataset -> SGD oracle -> lower the certificate to
R1CS on the host -> move it to the device -> transparent Spartan NIZK
prove -> verify, with the JAX CLI's stage lines ("Verification successful
for <name> [...]") and ``meta.json`` fields.

Not ported yet, and refused with an error naming the ROADMAP item rather
than replaced by something else: zero-knowledge proving (the JAX CLI's
default, so ``--transparent`` is required), ``--snark``, ``--mesh``,
``--batch``, ``--lp`` and ``--sdp``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

REFUSED = {
    "zk": "zero-knowledge proving is not ported yet (ROADMAP.md item 1.7); "
          "pass --transparent",
    "snark": "--snark (SNARK mode) is not ported yet (ROADMAP.md item 1.10)",
    "mesh": "--mesh (multi-GPU proving) is not ported yet (ROADMAP.md item 1.12)",
    "batch": "--batch is not ported yet (ROADMAP.md item 1.13)",
    "lp": "--lp is not ported yet (ROADMAP.md item 1.9)",
    "sdp": "--sdp is not ported yet (ROADMAP.md item 1.9)",
}

DEFAULT_DATASETS = os.environ.get(
    "OTTI_DATASETS",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets"),
)


def _stage(msg: str) -> None:
    print(msg, flush=True)


def native_backend() -> str:
    """Which host crypto backend native.py loaded."""
    from . import native

    return "C++ library" if native.HAVE_NATIVE else "pure-Python fallback"


# copied from otti_tpu/cli.py::Timer
class Timer:
    def __init__(self):
        self.t = {}

    @contextlib.contextmanager
    def time(self, name):
        t0 = time.time()
        yield
        self.t[name] = self.t.get(name, 0.0) + time.time() - t0

    def report(self):
        return "  ".join(f"{k}={v:.2f}s" for k, v in self.t.items())


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


_SHAPE_CLASSES_SEEN: set = set()


def prove_and_verify(shape, vars_, inputs, name: str, timer: Timer, out_dir=None,
                     device="cuda", extra_meta=None) -> bool:
    """Transparent NIZK prove + verify of one lowered instance on ``device``."""
    from . import metrics

    from .spartan import nizk, serial

    with timer.time("to_device"):
        dev = shape.to_device(device)
        _sync(device)
    _stage(f"Proving {name}: {shape.num_cons} constraints, "
           f"{shape.num_vars} vars, {shape.num_inputs} inputs")
    cls = (shape.num_cons_padded, shape.num_vars_padded, str(device))
    capture = "warm" if cls in _SHAPE_CLASSES_SEEN else "cold"
    _SHAPE_CLASSES_SEEN.add(cls)
    metrics.reset()
    with timer.time("prove"):
        proof = nizk.prove(dev, vars_, inputs)
        _sync(device)
    prove_metrics = metrics.snapshot()
    if timer.t.get("prove"):
        prove_metrics["constraints_per_s"] = round(shape.num_cons / timer.t["prove"], 1)
    with timer.time("verify"):
        ok = nizk.verify(dev, inputs, proof)
    if ok:
        _stage(f"Verification successful for {name}  "
               f"[{timer.report()}  proof={proof.size_bytes()}B]")
    else:
        _stage(f"VERIFICATION FAILED for {name}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        serial.save(proof, os.path.join(out_dir, name + ".proof.json"))
        with open(os.path.join(out_dir, name + ".meta.json"), "w") as f:
            json.dump(
                {
                    "name": name,
                    "mode": "plain",
                    "capture": capture,
                    "device": _device_name(device),
                    **(extra_meta or {}),
                    "num_cons": shape.num_cons,
                    "num_vars": shape.num_vars,
                    "num_inputs": shape.num_inputs,
                    "verified": bool(ok),
                    "proof_bytes": proof.size_bytes(),
                    "timings": timer.t,
                    "prover_metrics": prove_metrics,
                },
                f,
                indent=2,
            )
    return ok


def _device_name(device) -> str:
    if str(device).startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(torch.device(device))
    return str(device)


def lower_sgd(dataset: str, params: dict, prob_check: bool = False, timer=None):
    """Host stages of one SGD instance: fetch -> oracle -> lower.
    Returns (shape, vars, inputs, data_source, X.shape)."""
    from .io import pmlb_local
    from .oracle import sgd_oracle

    from .codegen import sgd_cert

    timer = timer or Timer()
    with timer.time("fetch"):
        X, ypm, data_source = pmlb_local.fetch(
            dataset, params["classes"][0], params["classes"][1],
            params["seed"], scale=int(params.get("scale", 1)),
        )
    with timer.time("oracle"):
        # prob mode proves margins over the first floor(n/2) samples only
        half = len(ypm) // 2
        Xo, yo = (X[:half], ypm[:half]) if prob_check else (X, ypm)
        w = sgd_oracle.solve(Xo, yo, seed=params["seed"], eta0=params["eta0"],
                             maxiter=params["maxiter"], tol=params["tol"])
    with timer.time("lower"):
        shape, vars_, inputs = sgd_cert.build(X, ypm, w, prob=prob_check)
    return shape, vars_, inputs, data_source, X.shape


def run_sgd(config_path, home_out, prove=True, prob_check=False, zk=False,
            batch=False, snark=False, mesh=None, device="cuda") -> bool:
    """Prove and verify every instance of a PMLB SGD config; artifacts go to
    ``<home_out>/SGD``.  Returns True when every instance verified."""
    from .io import pmlb_local

    for flag, on in (("zk", zk), ("snark", snark), ("mesh", mesh), ("batch", batch)):
        if on:
            raise NotImplementedError(REFUSED[flag])
    cfg = pmlb_local.load_config(config_path)
    out_dir = os.path.join(home_out, "SGD")
    ok_all = True
    for dataset, params in cfg.items():
        name = ("prob_" if prob_check else "") + dataset
        _stage(f"Compile, solve, and prove {dataset}")
        try:
            timer = Timer()
            shape, vars_, inputs, data_source, xshape = lower_sgd(
                dataset, params, prob_check, timer)
            _stage(f"  data: {data_source} ({xshape[0]}x{xshape[1]})")
            if not prove:
                _stage(f"  lowered {name}: {shape.num_cons} constraints [{timer.report()}]")
                continue
            ok_all &= prove_and_verify(
                shape, vars_, inputs, name, timer, out_dir, device,
                extra_meta={
                    "data_source": data_source,
                    "data_shape": list(xshape),
                    # the scale applies to cached real data only; the
                    # synthetic generator ignores it
                    "data_scale": int(params.get("scale", 1))
                    if data_source == "pmlb_cache" else None,
                },
            )
        except Exception as e:  # fail-soft per instance, as the JAX CLI
            _stage(f"INSTANCE FAILED {name}: {type(e).__name__}: {e}")
            ok_all = False
    return ok_all


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="otti-tpu-torch")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--small", action="store_true")
    group.add_argument("--full", action="store_true")
    group.add_argument("--config", type=str, help="an SGD config JSON (PMLB format)")
    parser.add_argument("--sgd", action="store_true")
    parser.add_argument("--lp", action="store_true")
    parser.add_argument("--sdp", action="store_true")
    parser.add_argument("--datasets", type=str, default=DEFAULT_DATASETS)
    parser.add_argument("--out", type=str, default="out")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--no-prove", action="store_true", help="stop after R1CS lowering")
    parser.add_argument("--transparent", action="store_true",
                        help="non-hiding transparent NIZK (the only mode ported)")
    parser.add_argument("--zk", action="store_true")
    parser.add_argument("--snark", action="store_true")
    parser.add_argument("--batch", action="store_true")
    parser.add_argument("--mesh", type=str, default=None)
    args = parser.parse_args(argv)
    if args.zk and args.transparent:
        parser.error("--zk and --transparent are mutually exclusive")
    for flag in ("lp", "sdp", "snark", "mesh", "batch"):
        if getattr(args, flag):
            parser.error(REFUSED[flag])
    if not args.transparent:  # zero knowledge is the default, as in otti_tpu
        parser.error(REFUSED["zk"])
    if not args.sgd:
        parser.print_help()
        return 0
    prove = not args.no_prove
    if args.config:
        configs = [(args.config, False)]
    elif args.full:
        configs = [(os.path.join(args.datasets, "SGD", "pmlb-full.json"), False),
                   (os.path.join(args.datasets, "SGD", "pmlb-prob.json"), True)]
    else:
        configs = [(os.path.join(args.datasets, "SGD", "pmlb-small.json"), False)]
    ok = True
    for path, prob in configs:
        _stage(f"Running SGD {os.path.basename(path)}")
        ok &= run_sgd(path, args.out, prove, prob_check=prob, device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
