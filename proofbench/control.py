"""The control and the planted faults, at a cell's own size:

    python3 -m proofbench.control --workload <cell> --seeds a,b,c --seconds <s> --fault <f>

runs the cell once for each seed with ``fault`` planted under the timed
path (faults.py) and prints each run's numbers compared; every run must
come out not correct.  The benchmark's own runs never plant a fault.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from contextlib import redirect_stdout

from . import cell as cell_mod
from . import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", choices=faults.FAULTS, default="witness")
    args = p.parse_args(argv)
    cell = cell_mod.load(args.workload)
    why = run.chips_missing(cell.chips)
    if why:
        print(f"[proofbench] {why}", file=sys.stderr)
        return run.EXIT_NO_CHIP
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = io.StringIO()
        with redirect_stdout(out):
            if cell.traffic["ranks"] > 1:
                from . import ranks

                ranks.launch(cell, seed, args.seconds, False, fault=args.fault)
            else:
                import torch

                run.emit(run.run_single(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                        t0=time.time(), fault=args.fault))
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        caught &= not res["correct"]
        print(json.dumps({"control": args.fault, "workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "checks": {k: c["value"] for k, c in res["checks"].items()}}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
