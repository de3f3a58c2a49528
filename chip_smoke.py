"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases (each prints a line; any failure exits non-zero):
  1. device   the card's name and power limit; the host crypto backend
  2. build    nvcc builds otti_tpu_torch/csrc/*.cu for sm_90a (one compiler
              per source, side by side); registers, spills and machine
              instructions by opcode of each
  3. kernel1  field multiply kernel == its plain torch version, 2^20 random
              semi-form pairs + edge values, both fields, shared operand,
              and the ragged sizes n in {1, 127, 129, 4097}
  4. kernel2  sumcheck round kernel == its plain version, full cubic and
              quadratic sumchecks at n in {2, 4, 8, 16, 32, 64, 256, 2^13,
              2^15}; the same bits on three runs of one input
  5. main     otti_tpu_torch.cli.run_sgd on optdigits 3v8 and iris 0v1 (real
              data in datasets/pmlb_cache), cold then warm, both kernels
              launched, a tampered public input rejected
  6. cpu_gpu  the same 1,024-constraint R1CS proved on the card and on the
              CPU gives byte-equal proofs
  7. scale    a 2^15-constraint R1CS (128 x 256 Hyrax grid) proved, cold and
              warm, with the prover's stage times
  8. profile  a warm optdigits prove: the multiply kernel's launch sizes by
              field and its time at the most frequent ones, both kernels'
              launches per prove; then torch.profiler over another: the
              device's busy share of the wall time and the top kernels

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.  ``--phases`` runs a comma-separated subset (development).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASES = ("device", "build", "kernel1", "kernel2", "main", "cpu_gpu", "scale", "profile")
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call.

    With queue_ahead the card is first kept busy by a spin kernel for longer
    than the host needs to enqueue the calls, so that the events bracket the
    kernels back to back and not the Python wrapper's time between launches
    (a wrapper call costs tens of microseconds on the host, more than a
    short kernel runs)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0  # enqueue time (the queue never fills at these counts)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2.0e9 * (1.5 * host_s + 200e-6)))  # cycles at under 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The card's published peaks (NVIDIA H100 SXM data sheet).  Integer work
# outside the tensor cores has no line there: the float32 rate of 67 TFLOP/s
# is 2 x 128 lanes x 132 SMs x 1.98 GHz, and 32-bit integer multiply-adds
# run on half of those lanes, which gives 16.75e12 multiply-adds a second.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 67e12 / 4
ROW_BYTES = 22 * 4
# 32x32->64 multiplies of one field multiply in csrc/field.cuh (8 x 8 words,
# then SCALAR: 4 x 9 + 4 x 5 + 4 x 1, BASE: 8 by the constant 38); each is
# two 32-bit multiply-adds (low and high half).
WIDE_MULS = {"scalar": 64 + 36 + 20 + 4, "base": 64 + 8}


def bound(n_bytes: float, n_muls: float, kind: str = "scalar") -> tuple:
    """(least ms the card could take, which of the two sets it): every input
    byte read once and every output byte written once at the memory rate,
    against the multiply-adds of n_muls field multiplies at the integer rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_muls * 2 * WIDE_MULS[kind] / INT32_MADS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mul_bound(kind: str, n: int, shared: bool = False) -> tuple:
    return bound((2 * n + (1 if shared else n)) * ROW_BYTES, n, kind)


def round_bound(degree: int, n: int) -> tuple:
    """A bind + evaluate round on tables of n rows whose previous active half
    is n / 2: every row read, n / 2 rows of each table written; n / 2
    multiplies a table in the bind, and 2 (cubic) or 1 (quadratic) a point
    over n / 4 pairs and 3 or 2 points."""
    ntab, k, per = (4, 3, 2) if degree == 3 else (2, 2, 1)
    return bound(ntab * (n + n // 2) * ROW_BYTES, ntab * (n // 2) + (n // 4) * k * per)


def phase_device(rec: dict) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    rec["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unavailable"
    from otti_tpu_torch import cli

    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"host crypto: {cli.native_backend()}")
    log(f"[device] nvidia-smi: {rec['smi']}")


def phase_build(rec: dict) -> None:
    from otti_tpu_torch import _build

    t0 = time.time()
    _build.library()
    log(f"[build] nvcc sm_90a build+load {time.time() - t0:.2f}s "
        f"(nvcc alone {_build.BUILD_SECONDS}s)")
    for name, text in _build.PTXAS_LOGS.items():
        for line in _build.ptxas_summary(text):
            log(f"[build] {name} {line}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        log("[build] cuobjdump not found: no SASS counts")
        return
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    for name, path in _build.LIB_PATHS.items():  # machine instructions by opcode
        sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                              timeout=120).stdout
        ops = collections.Counter(m.group(1) for m in opcode.finditer(sass))
        log(f"[build] {name} SASS: {sum(ops.values())} instructions; "
            + ", ".join(f"{c} {op}" for op, c in ops.most_common(8)))


def _semi(limbs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Same values, non-canonical limbs: move one unit of 2^12 down one limb
    at random positions (limbs above 2^12, and -1 where a limb was 0)."""
    x = limbs.clone()
    n = x.shape[0]
    for _ in range(3):
        pos = torch.randint(1, 22, (n,), generator=gen, device="cpu").to(x.device)
        pick = torch.rand(n, generator=gen, device="cpu").to(x.device) < 0.5
        rows = torch.arange(n, device=x.device)[pick]
        p = pos[pick]
        x[rows, p] -= 1
        x[rows, p - 1] += 4096
    return x


def phase_kernel1(rec: dict) -> None:
    from otti_tpu_torch.field import kernels as K
    from otti_tpu_torch.field.ops import BASE, SCALAR, int_to_limbs

    gen = torch.Generator().manual_seed(1)
    n = 1 << 20
    worst = 0
    times = {}
    for spec in (SCALAR, BASE):
        m = spec.modulus
        top = 2 if spec.kind == "scalar" else 16  # value < 2^253 / < 2^256
        def rand_limbs():
            x = torch.randint(0, 4096, (n, 22), generator=gen, dtype=torch.int32)
            x[:, 21] = torch.randint(0, top, (n,), generator=gen, dtype=torch.int32)
            return x
        a, b = rand_limbs(), rand_limbs()
        edges = [0, 1, m - 1, (1 << spec.semi_bound_bits) - 1]
        e = torch.from_numpy(np.stack([int_to_limbs(v) for v in edges]))
        ea = e.repeat_interleave(len(edges), 0)
        eb = e.repeat(len(edges), 1)
        a = torch.cat([a, ea]).cuda()
        b = torch.cat([b, eb]).cuda()
        a = _semi(a, gen)
        b = _semi(b, gen)
        got = K.mul_cuda(spec, a, b)
        want = K.mul_plain(spec, a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).any(-1).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"kernel1 {spec.kind}: mismatch at rows {bad}")
        s = a[7].contiguous()  # broadcast operand (the mul_scalar shape)
        got_b = K.mul_cuda(spec, b, s)
        want_b = K.mul_plain(spec, b, s)
        if not torch.equal(got_b, want_b):
            raise AssertionError(f"kernel1 {spec.kind}: broadcast mismatch")
        worst = max(worst, int((got - want).abs().max()), int((got_b - want_b).abs().max()))
        for m_rows in (1, 127, 129, 4097):  # ragged tiles, and a slice that is not 16-byte aligned
            for off in (0, 1):
                ar, br = a[off : off + m_rows], b[off : off + m_rows]
                for rhs in (br, s):
                    g, w = K.mul_cuda(spec, ar, rhs), K.mul_plain(spec, ar, rhs)
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"kernel1 {spec.kind}: mismatch at n={m_rows} offset {off} "
                            f"{'shared' if rhs is s else 'full'} operand")
        aa, bb = a[:n].contiguous(), b[:n].contiguous()
        t_k = cuda_ms(lambda: K.mul_cuda(spec, aa, bb), 20, queue_ahead=True)
        t_w = cuda_ms(lambda: K.mul_cuda(spec, aa, bb), 20)  # through the wrapper, as the prover pays it
        t_p = cuda_ms(lambda: K.mul_plain(spec, aa, bb), 3)
        times[spec.kind] = (t_k, t_p, t_w)
        t_s = cuda_ms(lambda: K.mul_cuda(spec, aa, s), 20, queue_ahead=True)
        b_ms, b_by = mul_bound(spec.kind, n)
        log(f"[kernel1] {spec.kind}: {n + len(edges) ** 2} pairs + shared operand + ragged "
            f"sizes exact; 2^20 muls kernel {t_k:.4f} ms (through the wrapper {t_w:.4f} ms, "
            f"shared operand {t_s:.4f} ms), "
            f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    b_ms, b_by = mul_bound("scalar", n)
    rec["kernel1"] = {"max_abs_err": worst, "ms": times["scalar"][0],
                      "plain_ms": times["scalar"][1], "wrapper_ms": times["scalar"][2], "bound_ms": b_ms, "bound_by": b_by,
                      "base": times["base"]}


def _run_sumcheck(fn, tables, degree, rs, snap=True):
    """All rounds of one sumcheck; returns (per-round evals, the active
    prefix of the tables after each round)."""
    n = tables[0].shape[0]
    evs = [fn(tables, degree)]
    active, j = n, 0
    snaps = []
    while active > 1:
        ev = fn(tables, degree, rs[j], active // 2)
        j += 1
        active //= 2
        evs.append(ev)
        if snap:
            snaps.append([t[:active].clone() for t in tables])
    return evs, snaps


def phase_kernel2(rec: dict) -> None:
    from otti_tpu_torch.field.ops import SCALAR, ints_to_limbs
    from otti_tpu_torch.spartan import sumcheck_kernels as SK

    rng = random.Random(2)
    M = SCALAR.modulus
    worst = 0
    times = {}
    for degree in (3, 2):
        for n in (1 << 15, 2, 4, 8, 16, 32, 64, 256, 1 << 13):
            k = 4 if degree == 3 else 2
            vals = [[rng.randrange(M) for _ in range(n)] for _ in range(k)]
            base = [torch.from_numpy(ints_to_limbs(v).reshape(n, 22)).cuda() for v in vals]
            rs = [rng.randrange(M) for _ in range(n.bit_length())]
            t_k = [t.clone() for t in base]
            t_p = [t.clone() for t in base]
            ev_k, sn_k = _run_sumcheck(SK.sumcheck_round_cuda, t_k, degree, rs)
            ev_p, sn_p = _run_sumcheck(SK.sumcheck_round_plain, t_p, degree, rs)
            torch.cuda.synchronize()
            for rnd, (a, b) in enumerate(zip(ev_k, ev_p)):
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"kernel2 deg {degree} n {n}: evals differ in round {rnd}")
                if a is not None:
                    worst = max(worst, int((a - b).abs().max()))
            for rnd, (sa, sb) in enumerate(zip(sn_k, sn_p)):
                for a, b in zip(sa, sb):
                    if not torch.equal(a, b):
                        raise AssertionError(f"kernel2 deg {degree} n {n}: tables differ after round {rnd}")
                    worst = max(worst, int((a - b).abs().max()))
            if n == 256:  # the same input three times: the same bits
                for _ in range(2):
                    t_again = [t.clone() for t in base]
                    ev_again, sn_again = _run_sumcheck(SK.sumcheck_round_cuda, t_again, degree, rs)
                    same = all(torch.equal(x, y) for x, y in zip(ev_again[:-1], ev_k[:-1]))
                    same = same and all(torch.equal(x, y) for sa, sb in zip(sn_again, sn_k)
                                        for x, y in zip(sa, sb))
                    if not same:
                        raise AssertionError(f"kernel2 deg {degree}: runs on one input differ")
            if n == 1 << 15:
                def full(fn):
                    tabs = [t.clone() for t in base]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _run_sumcheck(fn, tabs, degree, rs, snap=False)
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) * 1e3
                full(SK.sumcheck_round_cuda)
                tk = min(full(SK.sumcheck_round_cuda) for _ in range(3))
                tp = full(SK.sumcheck_round_plain)
                # one bind + evaluate round at the full size (ah = n/2)
                tabs = [t.clone() for t in base]
                rk = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, degree, rs[0], n // 2), 50,
                             queue_ahead=True)
                rw = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, degree, rs[0], n // 2), 50)
                rp = cuda_ms(lambda: SK.sumcheck_round_plain(tabs, degree, rs[0], n // 2), 3)
                times[degree] = (rk, rp, rw)
                small = [t[:32].clone() for t in base]  # one block: what a launch costs at least
                floor = cuda_ms(lambda: SK.sumcheck_round_cuda(small, degree, rs[0], 16), 50,
                                queue_ahead=True)
                b_ms, b_by = round_bound(degree, n)
                log(f"[kernel2] degree {degree} n=2^15: {n.bit_length()} rounds exact; "
                    f"first bind+eval round kernel {rk:.4f} ms (through the wrapper {rw:.4f} ms), "
                    f"plain {rp:.4f} ms, "
                    f"bound {b_ms:.4f} ms by {b_by}, a round at 32 rows {floor:.4f} ms; "
                    f"whole sumcheck (host-driven) kernel {tk:.3f} ms, plain {tp:.3f} ms")
            else:
                log(f"[kernel2] degree {degree} n={n}: all rounds exact")
    b_ms, b_by = round_bound(3, 1 << 15)
    rec["kernel2"] = {"max_abs_err": worst, "ms": times[3][0], "plain_ms": times[3][1],
                      "wrapper_ms": times[3][2],
                      "bound_ms": b_ms, "bound_by": b_by, "quad": times[2]}


def _config(path: str) -> None:
    with open(os.path.join(REPO, "datasets", "SGD", "pmlb-real-extra.json")) as f:
        extra = json.load(f)
    cfg = {
        "optdigits": extra["optdigits"],
        # the parameters of tests/test_codegen_sgd.py (iris 0 vs 1, seed 3)
        "iris": {"classes": [0, 1], "seed": 3, "eta0": 0.1, "maxiter": 1000, "tol": 1e-4},
    }
    with open(path, "w") as f:
        json.dump(cfg, f)


def phase_main(rec: dict) -> None:
    from otti_tpu_torch import _build, cli
    from otti_tpu_torch.spartan import nizk, serial

    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "smoke.json")
        _config(cfg)
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        for capture in ("cold", "warm"):
            out = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out):
                ok = cli.run_sgd(cfg, tmp, zk=False)
            torch.cuda.synchronize()
            wall = time.time() - t0
            text = out.getvalue()
            for line in text.splitlines():
                log(f"[main:{capture}] {line}")
            if not ok or text.count("Verification successful") != 2:
                raise AssertionError(f"main path ({capture}) did not verify both instances")
            for name in ("optdigits", "iris"):
                with open(os.path.join(tmp, "SGD", name + ".meta.json")) as f:
                    meta = json.load(f)
                if meta["data_source"] != "pmlb_cache" or not meta["verified"]:
                    raise AssertionError(f"{name}: {meta['data_source']}, verified={meta['verified']}")
                pm = meta["prover_metrics"]
                log(f"[main:{capture}] {name}: {meta['num_cons']} constraints, "
                    f"proof {meta['proof_bytes']} B, "
                    f"{pm.get('constraints_per_s')} constraints/s, timings "
                    + json.dumps({k: round(v, 4) for k, v in meta["timings"].items()})
                    + " prover " + json.dumps({k: round(v, 4) for k, v in pm.items()}))
                rec.setdefault("main", {})[f"{name}:{capture}"] = meta
            log(f"[main:{capture}] run_sgd wall {wall:.2f}s")
        rec["launches"] = dict(_build.LAUNCHES)
        log(f"[main] kernel launches during the main path: {rec['launches']}")
        for k, v in rec["launches"].items():
            if v <= 0:
                raise AssertionError(f"kernel {k} was not launched on the main path")
        # soundness probe: one public input changed must be rejected
        shape, vars_, inputs, _, _ = cli.lower_sgd(
            "iris", {"classes": [0, 1], "seed": 3, "eta0": 0.1, "maxiter": 1000, "tol": 1e-4})
        dev = shape.to_device("cuda")
        proof = serial.load(os.path.join(tmp, "SGD", "iris.proof.json"))
        if not nizk.verify(dev, inputs, proof):
            raise AssertionError("reloaded iris proof does not verify")
        bad = [inputs[0] + 1] + list(inputs[1:])
        if nizk.verify(dev, bad, proof):
            raise AssertionError("proof with a changed public input was accepted")
        log("[main] reloaded iris proof verifies; changed public input rejected")


def phase_cpu_gpu(rec: dict) -> None:
    from otti_tpu_torch.spartan import nizk, r1cs, serial

    shape, zvars = r1cs.random_satisfiable(1024, 256, seed=7)
    outs = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        dev = shape.to_device(device)
        proof = nizk.prove(dev, zvars, [])
        if not nizk.verify(dev, [], proof):
            raise AssertionError(f"{device} proof does not verify")
        outs[device] = serial.dumps(proof)
        log(f"[cpu_gpu] {device}: prove+verify {time.time() - t0:.2f}s")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("GPU and CPU proofs differ")
    log(f"[cpu_gpu] 1024-constraint proofs byte-equal ({len(outs['cuda'])} B of JSON)")


def phase_scale(rec: dict) -> None:
    """The padded size the JAX package ran optdigits at with sklearn's
    weights: 2^15 constraints, 2^15 variables, a 128 x 256 Hyrax grid
    (256-generator comb table, 128 MiB)."""
    from otti_tpu_torch.spartan import nizk, r1cs

    metrics = nizk.metrics
    shape, zvars = r1cs.random_satisfiable(1 << 15, 1 << 15, seed=11)
    dev = shape.to_device("cuda")
    for capture in ("cold", "warm"):
        metrics.reset()
        t0 = time.time()
        proof = nizk.prove(dev, zvars, [])
        torch.cuda.synchronize()
        t_prove = time.time() - t0
        t0 = time.time()
        ok = nizk.verify(dev, [], proof)
        t_verify = time.time() - t0
        if not ok:
            raise AssertionError("2^15 proof does not verify")
        snap = {k: round(v, 4) for k, v in metrics.snapshot().items()}
        log(f"[scale:{capture}] 2^15 x 2^15 R1CS: prove {t_prove:.3f}s verify {t_verify:.3f}s "
            f"proof {proof.size_bytes()} B; prover " + json.dumps(snap))
        rec.setdefault("scale", {})[capture] = {"prove_s": t_prove, "verify_s": t_verify, **snap}


def phase_profile(rec: dict) -> None:
    """torch.profiler over one warm optdigits prove: device busy share and
    the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from otti_tpu_torch import _build, cli
    from otti_tpu_torch.field import kernels as K
    from otti_tpu_torch.field.ops import BASE, SCALAR
    from otti_tpu_torch.spartan import nizk

    with open(os.path.join(REPO, "datasets", "SGD", "pmlb-real-extra.json")) as f:
        params = json.load(f)["optdigits"]
    shape, vars_, inputs, _, _ = cli.lower_sgd("optdigits", params)
    dev = shape.to_device("cuda")
    nizk.prove(dev, vars_, inputs)  # warm: comb table built
    torch.cuda.synchronize()

    # one warm prove with the multiply wrapper's calls written down
    sizes: dict = {}
    real_mul = K.mul_cuda

    def recording_mul(spec, a, b):
        key = (spec.kind, a.numel() // 22, b.dim() == 1)
        sizes[key] = sizes.get(key, 0) + 1
        return real_mul(spec, a, b)

    before = dict(_build.LAUNCHES)
    K.mul_cuda = recording_mul
    try:
        nizk.prove(dev, vars_, inputs)
        torch.cuda.synchronize()
    finally:
        K.mul_cuda = real_mul
    rec["launches_per_prove"] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    log(f"[profile] launches of one warm optdigits prove: {rec['launches_per_prove']}")
    gen = torch.Generator().manual_seed(3)
    for kind in ("scalar", "base"):
        rows = sorted(((c, n, sh) for (k, n, sh), c in sizes.items() if k == kind),
                      key=lambda t: -t[0] * t[1])  # by rows multiplied in the prove
        log(f"[profile] kernel1 {kind} launch sizes (rows: launches): "
            + ", ".join(f"{n}{'*' if sh else ''}: {c}" for c, n, sh in rows)
            + "  (*: shared operand)")
        spec = SCALAR if kind == "scalar" else BASE
        for rank, (c, n, sh) in enumerate(rows):
            x = torch.randint(0, 4096, (n, 22), generator=gen, dtype=torch.int32)
            x[:, 21] = 0
            x = _semi(x.cuda(), gen)
            y = x[0].contiguous() if sh else x.flip(0).contiguous()
            if not torch.equal(real_mul(spec, x, y), K.mul_plain(spec, x, y)):
                raise AssertionError(
                    f"kernel1 {kind}: kernel and plain differ at the prover's launch size "
                    f"n={n}{' shared' if sh else ''}")
            if rank >= 3:  # timed: the three sizes that multiply most rows in a prove
                continue
            t_k = cuda_ms(lambda: real_mul(spec, x, y), 50, queue_ahead=True)
            t_p = cuda_ms(lambda: K.mul_plain(spec, x, y), 3)
            b_ms, b_by = mul_bound(kind, n, sh)
            log(f"[profile] kernel1 {kind} n={n}{' shared' if sh else ''} ({c} launches a prove): "
                f"kernel {t_k:.5f} ms, plain {t_p:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
        log(f"[profile] kernel1 {kind}: kernel == plain at each of these {len(rows)} launch shapes")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        nizk.prove(dev, vars_, inputs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] optdigits warm prove wall {wall * 1e3:.1f} ms, device kernels "
        f"{busy_us / 1e3:.1f} ms busy ({100 * busy_us / 1e6 / wall:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    for e in events:  # the two hand-written kernels, wherever they rank
        if "field_mul_kernel" in e.key or "sumcheck_round_kernel" in e.key:
            log(f"[profile]   own kernel {e.self_device_time_total / 1e3:9.3f} ms  "
                f"{e.count:6d}x  {e.key[:70]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    rec: dict = {}
    fns = {"device": phase_device, "build": phase_build, "kernel1": phase_kernel1,
           "kernel2": phase_kernel2, "main": phase_main, "cpu_gpu": phase_cpu_gpu,
           "scale": phase_scale, "profile": phase_profile}
    for name in phases:
        t0 = time.time()
        fns[name](rec)
        log(f"[{name}] ok ({time.time() - t0:.1f}s)")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    strays = [m for m in sys.modules if m == "otti_tpu" or m.startswith("otti_tpu.")]
    if strays:
        raise AssertionError(f"modules of the JAX package were imported: {strays}")
    kernels = []
    launches = rec.get("launches", {})
    for key, cname, src, rep in (
        ("kernel1", "field_mul", "otti_tpu_torch/csrc/field_mul.cu",
         "otti_tpu/field/pallas_kernels.py:116"),
        ("kernel2", "sumcheck_round", "otti_tpu_torch/csrc/sumcheck_round.cu",
         "otti_tpu/spartan/pallas_sumcheck.py:252"),
    ):
        if key in rec:
            kernels.append({"name": cname, "route": "cuda", "source": src, "replaces": rep,
                            "launches": launches.get(cname, 0),
                            "max_abs_err": rec[key]["max_abs_err"],
                            "ms": rec[key]["ms"], "plain_ms": rec[key]["plain_ms"],
                            "bound_ms": rec[key]["bound_ms"],
                            "bound_by": rec[key]["bound_by"],
                            "library_ms": None,  # no PyTorch call computes either function
                            "wrapper_ms": rec[key]["wrapper_ms"],
                            "launches_per_prove":
                                rec.get("launches_per_prove", {}).get(cname)})
    log(rec.get("smi", ""))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
