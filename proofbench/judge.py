"""Whether a run was correct: the plain reference (reference/) against
what the program made, once the window has closed.

For every instance of the pool the reference makes the LP again from the
seed and lowers it itself; the program's R1CS must be that R1CS entry for
entry, and the program's witness must satisfy it.  A sample of the
window's proofs, drawn from the seed and spread over the pool, must verify
against the reference's R1CS.  Each number compared has the limit 0.
"""

from __future__ import annotations

import multiprocessing

import numpy as np

from . import lpgen
from .reference import lowering, verify

LIMITS = {"requests_failed": 0, "instances_differing": 0, "rows_unsatisfied": 0,
          "proofs_rejected": 0, "proofs_missing": 0}


def judge_instance(config: dict, seed: int, index: int, num_cons: int, num_vars: int,
                   num_inputs: int, mats: tuple, witness: list, inputs: list,
                   proofs: list) -> dict:
    """One instance: does the program's lowering match, does its witness
    satisfy, how many of its sampled proofs (canonical JSON) are rejected."""
    A, b, c = lpgen.make_lp(config["rows"], config["cols"], config["nnz"], seed, index)
    st = config["statement"]
    ref = lowering.lower(A, b, c, st["delta"], st["cap_bits"])
    differs = ((num_cons, num_vars, num_inputs) != (ref.num_cons, ref.num_vars, ref.num_inputs)
               or any(sorted(mats[m]) != ref.entries(m) for m in range(3)))
    return {"instances_differing": int(differs),
            "rows_unsatisfied": ref.unsatisfied(witness, inputs),
            "proofs_rejected": sum(not verify.verify(ref, inputs, p) for p in proofs)}


def sample(proofs: list, pool: int, n: int, seed: int) -> dict:
    """{instance: [positions in ``proofs``]}: ``n`` requests drawn from the
    seed, round robin over the pool's instances."""
    rng = np.random.default_rng([seed % 2**64, 2 << 20])
    left = {i: list(rng.permutation([p for p, (k, _) in enumerate(proofs) if k == i]))
            for i in range(pool)}
    out, i = {}, 0
    while sum(map(len, out.values())) < n and any(left.values()):
        if left[i % pool]:
            out.setdefault(i % pool, []).append(int(left[i % pool].pop()))
        i += 1
    return out


def judge(config: dict, seed: int, insts: list, proofs: list, failed: int, workers: int,
          dumps) -> dict:
    """{check: (value, limit)}; ``insts`` are serve.Instance, ``proofs``
    (instance, proof) of the window, ``dumps`` the proof's canonical JSON."""
    n = config["verify_sample"]
    picked = sample(proofs, len(insts), n, seed)
    jobs = []
    for inst in insts:
        sh = inst.shape
        jobs.append((config, seed, inst.index, sh.num_cons, sh.num_vars, sh.num_inputs,
                     (sh.A, sh.B, sh.C), inst.vars, inst.inputs,
                     [dumps(proofs[p][1]) for p in picked.get(inst.index, [])]))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, min(len(jobs), workers))) as ex:
        res = ex.starmap(judge_instance, jobs)
    got = {k: sum(r[k] for r in res) for k in res[0]}
    got["requests_failed"] = failed
    got["proofs_missing"] = n - sum(map(len, picked.values()))
    return {k: (got[k], LIMITS[k]) for k in LIMITS}
