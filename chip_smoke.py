"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases (each prints a line; any failure exits non-zero):
  1. device   the card's name and power limit; the host crypto backend, which
              must be the C++ library (the zk path does hundreds of host MSMs)
  2. build    nvcc builds otti_tpu_torch/csrc/*.cu for sm_90a (one compiler
              per source, side by side); registers, spills and machine
              instructions by opcode of each
  3. kernel1  field multiply kernel == its plain torch version, 2^20 random
              semi-form pairs + edge values, both fields, shared operand,
              and the ragged sizes n in {1, 127, 129, 4097}
  4. kernel2  sumcheck round kernel == its plain version, full cubic and
              quadratic sumchecks at n in {2, 4, 8, 16, 32, 64, 256, 2^10,
              2^11, 2^13, 2^14, 2^15}; the same bits on three runs of one input
  5. main     otti_tpu_torch.cli.run_sgd on optdigits 3v8 and iris 0v1 (real
              data in datasets/pmlb_cache), cold then warm: first transparent
              (zk=False), then in zero knowledge (the CLI's default), each by
              the device-transcript prover the CLI picks; every kernel
              launched in each, the saved iris proofs reloaded and
              verified, a changed public input rejected; iris once more under
              the "spartan" wire profile (zknizk.prove), which verifies under
              it and not under "otti"
  6. cpu_gpu  the same 1,024-constraint R1CS proved on the card and on the
              CPU gives byte-equal proofs, transparent and (one blind seed)
              zero-knowledge; two blind seeds give two proofs
  7. scale    a 2^15-constraint R1CS (128 x 256 Hyrax grid) proved, cold and
              warm, transparent then zero-knowledge, with the prover's stage
              times and the peak device memory of each prove
  8. lp_sdp   otti_tpu_torch.cli.run_lp and run_sdp on instances written from
              a seed (LPs of 27 x 32 and 117 x 225, the SDP
              sdpa.random_problem(3, 4, seed=1)), cold then warm in zero
              knowledge and once transparent; both kernels launched; the
              small LP written as a zkinterface triple and proved again from
              it through the command line; a saved proof rejected against
              the same LP under another tolerance
  9. snark    SNARK mode (SPARK commitments of the matrices, timed apart as
              snark_setup) through the CLI's functions on optdigits and on
              the 2^15 R1CS of phase 7, cold then warm, with peak device
              memory; K1, K2 and K5 launched (SPARK's sumchecks run each
              round, its transcript step included, as one K5 launch); a
              256-constraint R1CS proved on the
              card and on the CPU, the two proofs byte-equal; two tampered
              proofs rejected
 10. custom   SPARK's custom sumchecks at the full widths of both SNARK
              instances (mu_n, mu_x and mu_y printed): K5 == its plain
              version through whole sumchecks of both combinations (semi-form
              inputs, the first round, bound rounds with the challenge as an
              int and in device memory, down to one pair and the bare final
              bind); K5's fused entry (the round and its transcript step) ==
              custom_round_fs_plain through whole sumchecks (evaluations,
              the tables' active prefix, the transcript state and the
              challenge after every round); a bind + evaluate round of each
              shape timed, bare and fused, against the plain versions and the
              bound, the fused round's extra time at the smallest shape as
              its floor; prove_custom == prove_custom_device
              on the same tables, both timed; no host sync inside
              prove_custom_device (OTTI_SYNC_CHECK=1); then five warm SNARK
              proves of each instance with SPARK's sumchecks in the device
              form and in the host form (median, spread, spark_entry_s,
              spark_tables_s, K1-K5 launches, and for optdigits the device
              launches under torch.profiler).  Phase snark_warm (not in the
              default list) runs those proves alone: with ``--tree DIR`` it
              times the package of another checkout, such as the parent
              commit, in the same call
 11. device_fs the device transcript: measurement probes on ristretto.cuh and
              keccak.cuh (SASS of one square, old and new; a dependent
              square, multiply and permutation in one thread; the empty
              kernel); K3 (Keccak-f[1600], STROBE pad in the same launch)
              == plain over a chain of 64 permutations, every other one
              padded, and on 4,096 states with and without the pad; K4
              (ristretto encoding) == plain == the host library at n = 1,
              2, 11, the optdigits witness rows and 4,096; both timed at
              those sizes against their plain versions, bounds and
              critical-path floors; kernel 2 with its challenge in device
              memory == with it as an int (2^15 rows, both degrees); then
              optdigits 3v8 (hybrid), iris 0v1 (fused) and the LP 117 x 225
              (hybrid) proved in zero knowledge by the prover the CLI picks,
              byte-equal to zknizk.prove for one blind seed, cold and warm
              against it; fused and hybrid plain == nizk; a tampered proof
              rejected; no host sync between the two transfers
              (OTTI_SYNC_CHECK=1); the launches of a warm prove; run_sgd
              under OTTI_CLASSIC=1 (phase main drives the default), run_lp
              by default, K1-K4 launched; last, a warm optdigits
              zk prove under torch.profiler with the pad as a torch XOR and
              fused into K3: device launches, K3 and K4 device time, the
              proofs byte-equal
 12. profile  a warm optdigits prove, transparent, zero-knowledge (host
              transcript, then hybrid.prove_zk), then in SNARK mode: the
              multiply kernel's launch sizes by field, kernel == plain at
              each, its time at the most frequent ones, every kernel's
              launches per prove; then torch.profiler over another: the
              device's busy share of the wall time and the top kernels
 13. batch    batched proving (spartan/batched.py): eight LPs 117 x 225
              written from seeds 1-8 (one padded class, printed); kernel 2
              over a batch with one device challenge an instance == its
              plain version down to the bare final bind, at B = 8 x 2^13
              rows and at the shapes the batch path gives it (cubic on the
              class's constraint rows, quadratic on its z rows, B = 1, 4,
              8), each timed against single launches; four LPs through
              cli.run_lp(batch=True) in zero knowledge (every kernel
              launched) and transparent, every proof verified;
              prove_many_zk == hybrid.prove_zk == zknizk.prove for the same
              seeds and prove_many == hybrid.prove == nizk.prove, no host
              sync inside the batched chains; launches and warm time
              (median, min and max of 5 runs) of a batch at B = 4, 8
              against the single default (a batch of one) and classic
              provers, with the device memory each adds at its peak,
              overall and by stage
 14. mesh     sharded proving (parallel/hybrid_sharded.py) with 2 and 4 shards
              on the one card: kernel 2's batched entry with one shared
              device challenge == its plain version down to the bare final
              bind at the shard shapes (cubic [2, 2^13], [4, 2^12], quadratic
              [2, 2^14], [4, 2^13]); the LP 117 x 225 (zk, one seed, and
              plain) and optdigits (zk) proved byte-equal to hybrid.prove_zk /
              hybrid.prove and verified (every kernel launched), a tampered
              proof rejected, no host sync in a sharded prove
              (OTTI_SYNC_CHECK=1); the LP at k = 1, 2, 4: five warm runs,
              kernel and device launches, peak memory; cli.run_lp with --mesh
              (auto: k = 1 on one card)
 15. dist     proving across processes (runtime.init_distributed; the CLI's
              --coordinator, --num-hosts, --host-id): the var-base MSM
              (msm/pippenger.py::msm) on the card == the host library's at
              n = 96, 2^10, 2^16 (time, K1 launches, peak memory); two ranks
              on the one card under gloo: python -m otti_tpu_torch.cli --lp
              on the LP 117 x 225 with --mesh 2, transparent and zk, every
              rank verified, rank 0 alone writing --out, its transparent
              proof hybrid.prove's in one process; this script's
              --dist-worker as two ranks: hybrid_sharded.prove_zk across
              them == hybrid.prove_zk (one seed) on each, every kernel of the
              path launched on each (the counts set to 0 just before, read
              just after), a tampered proof rejected, sharded.py's four
              functions == one shard at 2^14 rows, five warm proves (median,
              launches, device launches) against one process at k = 2 and
              1; with two cards or more the same under NCCL, a card a rank,
              at W = 2 (and 4), with no host sync (OTTI_SYNC_CHECK)
 16. mono     the single-dispatch sharded provers (parallel/fused_prover.py,
              the CLI's --mesh under OTTI_MESH_MONOLITHIC=1): the LPs
              117 x 225 of seeds 1 and 2 (one class), zk (a blind seed an
              LP) and plain, at k = 1, 2, 4 shards on cuda:0, each core
              captured as one CUDA graph: the launches of the path (counts
              set to 0 just before the cold zk prove at k = 2), each cold
              prove (eager warm-up, capture and instantiation) byte-equal
              to hybrid's and verified, a tampered proof rejected, LP 2
              replayed through LP 1's graph == hybrid == the eager core (no
              host sync), five warm replays and one under torch.profiler
              (graph launches, device launches, busy share), each graph's
              pool, beside three warm runs of hybrid / hybrid_sharded;
              optdigits zk at k = 2; with two cards or more run_lp(mesh=
              'auto') under it (uncaptured, meta graph false), the CLI as
              two NCCL ranks (graph true) and this script's --mono-worker
              as 2 (and 4) NCCL ranks, each rank's core captured and
              replayed, == hybrid on each rank.  Phase mono_cards (not in
              the default list) runs that part over several cards alone

 17. zk_round kernel K6 (spartan/zk_round_kernel.py), a zero-knowledge
              sumcheck round after its evaluations in one launch, == the
              torch round on the card (zkfused._zk_round_plain) at degree 3
              (phase 1) and 2 (phase 2), one instance and a batch of 8,
              semi-form claims: e_next, r, the encodings, z, zdb and the
              sponge state; both timed at one instance (device time behind
              the spin kernel, and the wrapper's), beside K4's encoding of
              two points and K3's permutation of one state, whose times
              make the round's floor (three encodings and the round's
              permutations, counted by the host Merlin)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.  ``--phases`` runs a comma-separated subset (development).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASES = ("device", "build", "kernel1", "kernel2", "main", "cpu_gpu", "scale", "lp_sdp", "snark",
          "custom", "device_fs", "profile", "batch", "mesh", "dist", "mono", "zk_round")
REPO = os.path.dirname(os.path.abspath(__file__))

HOST_FS_KERNELS = ("field_mul", "sumcheck_round")  # the paths with the host transcript
# the device-transcript NIZK paths (the CLI's defaults, batch, mesh)
DFS_KERNELS = ("field_mul", "sumcheck_round", "keccak_f1600", "ristretto_encode")
# their zero-knowledge form: each zk sumcheck round after its evaluations is K6
ZK_KERNELS = DFS_KERNELS + ("zk_round",)
# SNARK mode: SPARK's custom sumchecks run K5, a round's transcript step
# inside its launch; its commitments are encoded on the host
SNARK_KERNELS = ("field_mul", "sumcheck_round", "custom_round")
# the hand-written kernels' symbol names, as a profiler shows them
OWN_KERNELS = ("field_mul_kernel", "sumcheck_round_kernel", "keccak_kernel",
               "ristretto_encode_kernel", "custom_round_kernel", "zk_round_kernel")


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


def round_bound(degree: int, n: int, instances: int = 1) -> tuple:
    """A bind + evaluate round on tables of n rows whose previous active half
    is n / 2: every row read, n / 2 rows of each table written; n / 2
    multiplies a table in the bind, and 2 (cubic) or 1 (quadratic) a point
    over n / 4 pairs and 3 or 2 points; ``instances`` times that for a
    batched round."""
    ntab, k, per = (4, 3, 2) if degree == 3 else (2, 2, 1)
    return bound(instances * ntab * (n + n // 2) * ROW_BYTES,
                 instances * (ntab * (n // 2) + (n // 4) * k * per))


def phase_device(rec: dict) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    rec["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unavailable"
    from otti_tpu_torch import cli, native

    if not native.HAVE_NATIVE:  # seconds per host MSM on the fallback: another program's times
        raise AssertionError("the host C++ library did not build or load; "
                             "the smoke run does not prove through the pure-Python fallback")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"host crypto: {cli.native_backend()}")
    log(f"[device] nvidia-smi: {rec['smi']}")


# What ptxas reported for each kernel before K3 and K4 were redesigned
# (PERF.md, section 6): kernels 1 and 2 must compile as they did then.
PTXAS_EARLIER = {"field_mul": "83 and 66 registers, no spills, 45,072 B shared",
                 "sumcheck_round": "80 registers, 120 B stack, no spills, 28,364 B shared",
                 "keccak": "26 registers, no spills, 440 B shared (one warp a state in shared "
                           "memory)",
                 "ristretto_encode": "126 registers, no spills",
                 "custom_round": "80 registers, no spills, 17,796 B static shared (before its "
                                 "redesign: one kernel for both combinations)",
                 "zk_round": "none (a new kernel)"}


def phase_build(rec: dict) -> None:
    from otti_tpu_torch import _build

    t0 = time.time()
    _build.library()
    log(f"[build] nvcc sm_90a build+load {time.time() - t0:.2f}s "
        f"(nvcc alone {_build.BUILD_SECONDS}s)")
    for name, text in _build.PTXAS_LOGS.items():
        for line in _build.ptxas_summary(text):
            log(f"[build] {name} {line}")
            regs = re.search(r"Used (\d+) registers", line)
            spills = re.search(r"(\d+) bytes spill stores", line)
            if (regs and int(regs.group(1)) > 128) or (spills and int(spills.group(1))):
                raise AssertionError(f"{name}: over 128 registers or spilling: {line}")
        log(f"[build] {name} earlier: {PTXAS_EARLIER[name]}")
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
            + ", ".join(f"{c} {op}" for op, c in ops.most_common(8))
            + (f"; shuffles {ops['SHFL']}, WARPSYNC {ops['WARPSYNC']}, ENDCOLLECTIVE "
               f"{ops['ENDCOLLECTIVE']}" if ops["SHFL"] else ""))


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
    """All rounds of one sumcheck (tables [n, 22], or [B, n, 22] with a
    challenge [B, 22] an instance); returns (per-round evals, the active
    prefix of the tables after each round)."""
    n = tables[0].shape[-2]
    evs = [fn(tables, degree)]
    active, j = n, 0
    snaps = []
    while active > 1:
        ev = fn(tables, degree, rs[j], active // 2)
        j += 1
        active //= 2
        evs.append(ev)
        if snap:
            snaps.append([t[..., :active, :].clone() for t in tables])
    return evs, snaps


def phase_kernel2(rec: dict) -> None:
    from otti_tpu_torch.field.ops import SCALAR, ints_to_limbs
    from otti_tpu_torch.spartan import sumcheck_kernels as SK

    rng = random.Random(2)
    M = SCALAR.modulus
    worst = 0
    times = {}
    for degree in (3, 2):
        for n in (1 << 15, 2, 4, 8, 16, 32, 64, 256, 1 << 10, 1 << 11, 1 << 13, 1 << 14):
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


def write_lp_mps(path: str, m: int, n: int, seed: int) -> None:
    """An LP made from a seed, as a free-format MPS file: min c x with
    A x <= b, x >= 0 (no BOUNDS section).  A >= 0 is sparse with every row
    and column covered, b = A x0 + slack for an integer x0 >= 0 and c < 0:
    feasible and bounded by construction, so the LP oracle's row duals close
    the duality gap."""
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n))
    for j in range(n):
        rows = rng.choice(m, size=min(m, 3), replace=False)
        A[rows, j] = rng.integers(1, 10, size=len(rows))
    for i in range(m):
        if not A[i].any():
            A[i, rng.integers(n)] = float(rng.integers(1, 10))
    b = A @ rng.integers(0, 5, size=n) + rng.integers(0, 4, size=m)
    c = -rng.integers(1, 10, size=n)
    with open(path, "w") as f:
        f.write(f"NAME GEN{m}X{n}\nROWS\n N  COST\n")
        f.writelines(f" L  R{i}\n" for i in range(m))
        f.write("COLUMNS\n")
        for j in range(n):
            f.write(f"    X{j} COST {float(c[j])!r}\n")
            f.writelines(f"    X{j} R{i} {float(A[i, j])!r}\n" for i in range(m) if A[i, j])
        f.write("RHS\n")
        f.writelines(f"    RHS R{i} {float(b[i])!r}\n" for i in range(m))
        f.write("ENDATA\n")


def write_sdp_dats(path: str, prob) -> None:
    """An ``SDPProblem`` (io/sdpa.py) as an SDPA sparse file of one block:
    m, 1, n, b, then the upper triangles of C (matrix 0) and A_1..A_m.
    ``repr`` of a double parses back to the same double."""
    with open(path, "w") as f:
        f.write(f"{prob.m}\n1\n{prob.n}\n" + " ".join(repr(float(v)) for v in prob.b) + "\n")
        for k, mat in enumerate([prob.C] + list(prob.A)):
            f.writelines(f"{k} 1 {i + 1} {j + 1} {float(mat[i, j])!r}\n"
                         for i in range(prob.n) for j in range(i, prob.n) if mat[i, j])


IRIS = {"classes": [0, 1], "seed": 3, "eta0": 0.1, "maxiter": 1000, "tol": 1e-4}


def _config(path: str, names=("optdigits", "iris")) -> None:
    with open(os.path.join(REPO, "datasets", "SGD", "pmlb-real-extra.json")) as f:
        extra = json.load(f)
    # iris: the parameters of tests/test_codegen_sgd.py (iris 0 vs 1, seed 3)
    cfg = {"optdigits": extra["optdigits"], "iris": IRIS}
    with open(path, "w") as f:
        json.dump({k: cfg[k] for k in names}, f)


def _drive_run_sgd(rec: dict, tag: str, cfg: str, out_dir: str, names, mode: str,
                   kernels=DFS_KERNELS, **kw) -> dict:
    """cli.run_sgd on ``cfg``, cold then warm, with the launch counts set to 0
    just before and read just after (``kernels``: those that must have run);
    every instance must verify and its meta must name ``mode``.  Returns the
    counts."""
    from otti_tpu_torch import cli

    _zero_launches()
    for capture in ("cold", "warm"):
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            ok = cli.run_sgd(cfg, out_dir, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        text = out.getvalue()
        for line in text.splitlines():
            log(f"[main:{tag}:{capture}] {line}")
        if not ok or text.count("Verification successful") != len(names):
            raise AssertionError(f"main path ({tag}, {capture}) did not verify every instance")
        for name in names:
            with open(os.path.join(out_dir, "SGD", name + ".meta.json")) as f:
                meta = json.load(f)
            if meta["data_source"] != "pmlb_cache" or not meta["verified"]:
                raise AssertionError(f"{name}: {meta['data_source']}, verified={meta['verified']}")
            if meta["mode"] != mode or meta["capture"] != capture:
                raise AssertionError(f"{name}: mode {meta['mode']!r} capture {meta['capture']!r}, "
                                     f"expected {mode!r} {capture!r}")
            pm = meta["prover_metrics"]
            log(f"[main:{tag}:{capture}] {name}: {meta['num_cons']} constraints, "
                f"proof {meta['proof_bytes']} B, "
                f"{pm.get('constraints_per_s')} constraints/s, timings "
                + json.dumps({k: round(v, 4) for k, v in meta["timings"].items()})
                + " prover " + json.dumps({k: round(v, 4) for k, v in pm.items()}))
            rec.setdefault("main", {})[f"{tag}:{name}:{capture}"] = meta
        log(f"[main:{tag}:{capture}] run_sgd wall {wall:.2f}s")
    return _read_launches(f"main:{tag}", kernels)


def phase_main(rec: dict) -> None:
    from otti_tpu_torch import cli
    from otti_tpu_torch.spartan import nizk, serial, zknizk

    both = ("optdigits", "iris")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "smoke.json")
        _config(cfg)
        plain_dir, zk_dir, wire_dir = (os.path.join(tmp, d) for d in ("plain", "zk", "wire"))
        rec["launches_transparent"] = _drive_run_sgd(
            rec, "plain", cfg, plain_dir, both, "plain", zk=False)
        # the CLI's default path: zero knowledge
        rec["launches"] = _drive_run_sgd(rec, "zk", cfg, zk_dir, both, "zk", zk=True)
        cfg_iris = os.path.join(tmp, "iris.json")
        _config(cfg_iris, ("iris",))
        _drive_run_sgd(rec, "zk-spartan", cfg_iris, wire_dir, ("iris",), "zk-wire-spartan",
                       kernels=HOST_FS_KERNELS, zk=True, wire="spartan")

        # reload what was saved; one public input changed must be rejected
        shape, vars_, inputs, _, _ = cli.lower_sgd("iris", IRIS)
        dev = shape.to_device("cuda")
        bad = [inputs[0] + 1] + list(inputs[1:])
        for tag, out_dir, mod, kw in (("plain", plain_dir, nizk, {}),
                                      ("zk", zk_dir, zknizk, {}),
                                      ("zk-spartan", wire_dir, zknizk, {"wire": "spartan"})):
            proof = serial.load(os.path.join(out_dir, "SGD", "iris.proof.json"))
            want = "ZKNIZKProof" if mod is zknizk else "NIZKProof"
            if type(proof).__name__ != want:
                raise AssertionError(f"{tag}: saved proof is a {type(proof).__name__}")
            if not mod.verify(dev, inputs, proof, **kw):
                raise AssertionError(f"reloaded iris {tag} proof does not verify")
            if mod.verify(dev, bad, proof, **kw):
                raise AssertionError(f"{tag} proof with a changed public input was accepted")
            if tag == "zk-spartan" and zknizk.verify(dev, inputs, proof, wire="otti"):
                raise AssertionError("a proof under the spartan profile verified under otti")
        log("[main] reloaded iris proofs (plain, zk, zk under the spartan profile) verify; "
            "changed public input rejected by each; the spartan-profile proof is rejected "
            "under otti")


def phase_cpu_gpu(rec: dict) -> None:
    from otti_tpu_torch.spartan import nizk, r1cs, serial, zknizk

    shape, zvars = r1cs.random_satisfiable(1024, 256, seed=7)
    seed = bytes(range(32))
    provers = (
        ("plain", lambda dev: nizk.prove(dev, zvars, []), nizk.verify),
        ("zk", lambda dev: zknizk.prove(dev, zvars, [], seed=seed), zknizk.verify),
    )
    for tag, prove, verify in provers:
        outs = {}
        for device in ("cuda", "cpu"):
            t0 = time.time()
            dev = shape.to_device(device)
            proof = prove(dev)
            if not verify(dev, [], proof):
                raise AssertionError(f"{device} {tag} proof does not verify")
            outs[device] = serial.dumps(proof)
            log(f"[cpu_gpu] {tag} {device}: prove+verify {time.time() - t0:.2f}s")
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"GPU and CPU {tag} proofs differ")
        log(f"[cpu_gpu] 1024-constraint {tag} proofs byte-equal ({len(outs['cuda'])} B of JSON)")
    dev = shape.to_device("cuda")
    other = serial.dumps(zknizk.prove(dev, zvars, [], seed=b"\x05" * 32))
    if other == outs["cuda"]:
        raise AssertionError("two blind seeds gave one zk proof")
    log("[cpu_gpu] two blind seeds give two zk proofs")


def _add_tree_cut(rows: int, cols: int) -> None:
    """What the blind column costs the commitment's add tree: sum_points over
    rows x (cols * 32) gathered points (no blind) and over rows x ((cols + 1)
    * 32) as the port cuts it (the points beyond the largest power of two
    folded in first, nothing padded).  The sum must not depend on the cut: it
    is held against the same points padded with identities to the next power
    of two.  Five rounds in turn, medians."""
    from otti_tpu_torch.curve import edwards as E
    from otti_tpu_torch.msm import pippenger
    from otti_tpu_torch.spartan.nizk import GENS_LABEL

    tbl = pippenger.fixed_base_tables(cols, GENS_LABEL, True, "cuda")["p"]
    gen = torch.Generator().manual_seed(5)
    n = (cols + 1) * pippenger.N_WIN
    idx = torch.randint(0, tbl.shape[0], (rows, n), generator=gen).cuda()
    pts = E.from_affine_pack(tbl[idx])
    n_pad = 1 << (n - 1).bit_length()
    pad = E.identity((rows, n_pad - n), "cuda")
    cases = {
        f"{cols * pippenger.N_WIN} (no blind)": E.tree_map(lambda a: a[:, : cols * pippenger.N_WIN], pts),
        f"{n} (blind, unpadded)": pts,
    }
    padded = E.tree_map(lambda a, b: torch.cat([a, b], dim=1), pts, pad)
    want = E.to_affine_pack(E.sum_points(pts, axis=1))
    if not torch.equal(E.to_affine_pack(E.sum_points(padded, axis=1)), want):
        raise AssertionError("the add tree's sum depends on how it is cut")
    times = {k: [] for k in cases}
    for _ in range(5):
        for k, p in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            E.sum_points(p, axis=1)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    log(f"[scale] add tree of {rows} rows, wall ms (median of 5, launches sent from the host): "
        + "; ".join(f"{k} {sorted(v)[2]:.2f}" for k, v in times.items())
        + "; both cuts give the same points")


def phase_scale(rec: dict) -> None:
    """The padded size the JAX package ran optdigits at with sklearn's
    weights: 2^15 constraints, 2^15 variables, a 128 x 256 Hyrax grid
    (256-generator comb table, 128 MiB; one generator more with the blind)."""
    from otti_tpu_torch import metrics
    from otti_tpu_torch.spartan import nizk, r1cs, zknizk

    shape, zvars = r1cs.random_satisfiable(1 << 15, 1 << 15, seed=11)
    dev = shape.to_device("cuda")
    for tag, mod in (("plain", nizk), ("zk", zknizk)):
        for capture in ("cold", "warm"):
            metrics.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            proof = mod.prove(dev, zvars, [])
            torch.cuda.synchronize()
            t_prove = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            t0 = time.time()
            ok = mod.verify(dev, [], proof)
            t_verify = time.time() - t0
            if not ok:
                raise AssertionError(f"2^15 {tag} proof does not verify")
            snap = {k: round(v, 4) for k, v in metrics.snapshot().items()}
            log(f"[scale:{tag}:{capture}] 2^15 x 2^15 R1CS: prove {t_prove:.3f}s "
                f"verify {t_verify:.3f}s proof {proof.size_bytes()} B, peak device memory "
                f"{peak / 2**20:.1f} MiB; prover " + json.dumps(snap))
            rec.setdefault("scale", {})[f"{tag}:{capture}"] = {
                "prove_s": t_prove, "verify_s": t_verify, "peak_bytes": peak, **snap}
    _add_tree_cut(64, 128)  # the optdigits grid on this machine
    _add_tree_cut(128, 256)  # the 2^15 grid


def _zero_launches() -> None:
    from otti_tpu_torch import _build

    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


def _read_launches(tag: str, kernels=DFS_KERNELS) -> dict:
    """The counts since _zero_launches; every kernel of ``kernels`` must
    have been launched."""
    from otti_tpu_torch import _build

    launches = dict(_build.LAUNCHES)
    log(f"[{tag}] kernel launches during this path: {launches}")
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {tag} path")
    return launches


def _captured(tag: str, fn, *args, **kw):
    """fn(...) with its stage lines re-logged under ``tag``; (result, text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    torch.cuda.synchronize()
    for line in out.getvalue().splitlines():
        log(f"[{tag}] {line}")
    return res, out.getvalue()


def _check_meta(tag: str, path: str, mode: str, capture=None) -> dict:
    with open(path) as f:
        meta = json.load(f)
    # a first pass reads "warm" where an earlier phase proved this padded shape and mode
    if not meta["verified"] or meta["mode"] != mode or (capture == "warm" != meta["capture"]):
        raise AssertionError(f"{path}: verified={meta['verified']} mode {meta['mode']!r} "
                             f"capture {meta.get('capture')!r}, expected {mode!r} {capture!r}")
    if meta["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"{path}: ran on {meta['device']!r}")
    pm = meta["prover_metrics"]
    log(f"[{tag}] {meta['name']}: {meta['num_cons']} constraints, proof {meta['proof_bytes']} B, "
        f"{pm.get('constraints_per_s')} constraints/s, timings "
        + json.dumps({k: round(v, 4) for k, v in meta["timings"].items()})
        + " prover " + json.dumps({k: round(v, 4) for k, v in pm.items()}))
    return meta


def phase_lp_sdp(rec: dict) -> None:
    """LP and SDP certificates through cli.run_lp / cli.run_sdp, on files
    written from a seed (the Netlib and SDPLIB suites are not in the
    repository): afiro's shape 27 x 32, 117 x 225, and the largest random SDP
    tried that the oracle solves."""
    from otti_tpu_torch import _build, cli
    from otti_tpu_torch.codegen import lp_cert
    from otti_tpu_torch.io import mps, sdpa
    from otti_tpu_torch.oracle import lp_oracle
    from otti_tpu_torch.spartan import serial, zknizk

    with tempfile.TemporaryDirectory() as tmp:
        lps = []
        for m, n in ((27, 32), (117, 225)):
            lps.append(os.path.join(tmp, f"gen{m}x{n}.mps"))
            write_lp_mps(lps[-1], m, n, seed=1)
        sdp = os.path.join(tmp, "rand3x4.dat-s")
        write_sdp_dats(sdp, sdpa.random_problem(3, 4, seed=1)[0])
        zk_dir, plain_dir = os.path.join(tmp, "zk"), os.path.join(tmp, "plain")
        jobs = [(cli.run_lp, "LP", p) for p in lps] + [(cli.run_sdp, "SDP", sdp)]

        _zero_launches()
        per_run = {}
        for capture in ("cold", "warm"):
            for fn, kind, path in jobs:
                name = os.path.basename(path)
                before = dict(_build.LAUNCHES)
                ok, text = _captured(f"lp_sdp:zk:{capture}", fn, [path], zk_dir, zk=True)
                if not ok or "Verification successful for " + name not in text:
                    raise AssertionError(f"{name} (zk, {capture}) did not verify")
                _check_meta(f"lp_sdp:zk:{capture}",
                            os.path.join(zk_dir, kind, name + ".meta.json"), "zk", capture)
                per_run[name] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        rec["launches_lp_sdp"] = _read_launches("lp_sdp:zk", ZK_KERNELS)
        rec.setdefault("launches_per_prove", {}).update(
            {f"zk+verify:{name}": v for name, v in per_run.items()})
        log(f"[lp_sdp:zk] launches of one warm prove + verify: {per_run}")

        for fn, kind, path in (jobs[0], jobs[2]):  # once transparent
            name = os.path.basename(path)
            ok, _ = _captured("lp_sdp:plain", fn, [path], plain_dir, zk=False)
            if not ok:
                raise AssertionError(f"{name} (transparent) did not verify")
            _check_meta("lp_sdp:plain", os.path.join(plain_dir, kind, name + ".meta.json"),
                        "plain")

        # the zkinterface triple of the small LP, written and proved again
        # from the files, through the command line (device: the default)
        zkif_dir, back_dir = os.path.join(tmp, "zkif"), os.path.join(tmp, "back")
        rc, _ = _captured("lp_sdp:zkif", cli.main,
                          ["--lp", "--custom", lps[0], "--emit-zkif", "--out", zkif_dir])
        base = os.path.join(zkif_dir, "LP", os.path.basename(lps[0]))
        triple = [base + ext for ext in (".zkif", ".inp.zkif", ".wit.zkif")]
        if rc != 0 or not all(os.path.getsize(p) > 0 for p in triple):
            raise AssertionError("--emit-zkif did not write the triple")
        rc, text = _captured("lp_sdp:zkif", cli.main, ["--verify-zkif"] + triple + ["--out", back_dir])
        if rc != 0 or "Verification successful" not in text:
            raise AssertionError("--verify-zkif did not verify the exported instance")
        a = _check_meta("lp_sdp:zkif", base + ".meta.json", "zk")
        b = _check_meta("lp_sdp:zkif",
                        os.path.join(back_dir, os.path.basename(triple[0]) + ".meta.json"), "zk")
        if (a["num_cons"], a["num_vars"]) != (b["num_cons"], b["num_vars"]):
            raise AssertionError("the imported instance has another size")
        log(f"[lp_sdp:zkif] exported {sum(os.path.getsize(p) for p in triple)} B in 3 files, "
            "imported, proved and verified again")

        # an LP has no public inputs: the statement is the instance and its
        # tolerance.  The saved proof against the same LP under another delta:
        prob = mps.parse_mps(lps[0])
        x, y, _ = lp_oracle.solve(prob)
        proof = serial.load(os.path.join(zk_dir, "LP", os.path.basename(lps[0]) + ".proof.json"))
        for delta, want in ((lp_cert.DELTA, True), (0.02, False)):
            shape, _, inputs = lp_cert.build(prob, x, y, delta=delta)
            if zknizk.verify(shape.to_device("cuda"), inputs, proof) != want:
                raise AssertionError(f"saved LP proof under delta={delta}: expected {want}")
        log("[lp_sdp] the saved LP proof reloads and verifies; against the same LP lowered "
            "with delta = 0.02 it is rejected")


def phase_snark(rec: dict) -> None:
    """SNARK mode through the CLI's functions: optdigits 3v8 by run_sgd, the
    2^15 R1CS of phase scale by prove_and_verify (this path at full width)."""
    from otti_tpu_torch import cli
    from otti_tpu_torch.spartan import r1cs, serial, snark, spark

    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "optdigits.json")
        _config(cfg, ("optdigits",))
        shape, zvars = r1cs.random_satisfiable(1 << 15, 1 << 15, seed=11)
        _zero_launches()
        for capture in ("cold", "warm"):
            for name, run in (
                ("optdigits", lambda: cli.run_sgd(cfg, tmp, zk=False, snark=True)),
                ("r1cs2p15", lambda: cli.prove_and_verify(
                    shape, zvars, [], "r1cs2p15", cli.Timer(), os.path.join(tmp, "SGD"),
                    zk=False, snark=True, device="cuda")),
            ):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ok, _ = _captured(f"snark:{capture}", run)
                peak = torch.cuda.max_memory_allocated()
                if not ok:
                    raise AssertionError(f"SNARK of {name} ({capture}) did not verify")
                meta = _check_meta(f"snark:{capture}",
                                   os.path.join(tmp, "SGD", name + ".meta.json"), "snark", capture)
                if "snark_setup" not in meta["timings"]:
                    raise AssertionError("snark_setup was not timed apart")
                log(f"[snark:{capture}] {name}: snark_setup {meta['timings']['snark_setup']:.3f}s "
                    f"prove {meta['timings']['prove']:.3f}s verify {meta['timings']['verify']:.3f}s "
                    f"proof {meta['proof_bytes']} B, peak device memory {peak / 2**20:.1f} MiB "
                    "(setup, prove and verify)")
        rec["launches_snark"] = _read_launches("snark", SNARK_KERNELS)
        proof = serial.load(os.path.join(tmp, "SGD", "optdigits.proof.json"))
        if type(proof).__name__ != "SNARKProof":
            raise AssertionError(f"saved proof is a {type(proof).__name__}")

    # card == CPU, and tampering
    shape, zvars = r1cs.random_satisfiable(256, 64, seed=7)  # on the CPU a minute at 1,024
    outs = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        dev = shape.to_device(device)
        comm = spark.commit(dev)
        proof = snark.prove(dev, comm, zvars, [])
        if not snark.verify(dev, comm, [], proof):
            raise AssertionError(f"{device} SNARK proof does not verify")
        outs[device] = (serial.dumps(proof), comm.transcript_bytes())
        log(f"[snark] 256-constraint R1CS on {device}: commit+prove+verify {time.time() - t0:.2f}s")
        if device == "cuda":
            ea, eb, ec = proof.evals_abc
            sp = proof.spark_proof
            mod = snark.MOD
            bad_eval = dataclasses.replace(proof, evals_abc=(ea, (eb + 1) % mod, ec))
            bad_sum = dataclasses.replace(proof, spark_proof=dataclasses.replace(
                sp, s_R_row=(sp.s_R_row + 1) % mod))
            if snark.verify(dev, comm, [], bad_eval) or snark.verify(dev, comm, [], bad_sum):
                raise AssertionError("a tampered SNARK proof was accepted")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("GPU and CPU SNARK proofs (or SPARK commitments) differ")
    log(f"[snark] card and CPU SNARK proofs byte-equal ({len(outs['cuda'][0])} B of JSON); "
        "a tampered evals_abc and a tampered s_R_row rejected")


# Field multiplies of each combination in csrc/custom_round.cu: a
# (pair, point) term's products without the constants (spark_entry4 3 + 2 +
# 2, spark_table 1 + 2), and the constants once a point (4 and 2).
CUSTOM_MULS = {"spark_entry4": (7, 4), "spark_table": (3, 2)}
SNARK_RUNS = 5  # warm SNARK proves timed a form and instance


def custom_bound(key: str, ah: int) -> tuple:
    """A bind + evaluate round of K5 with previous active half ah: 2 ah rows
    of each of the k tables read and ah written (k * 3 * ah * 88 B); k * ah
    multiplies in the bind, CUSTOM_MULS[key] a point over ah / 2 pairs and
    once a point.  The fused round adds 400 B of transcript state, and
    about three permutations of one state: nothing at these scales."""
    from otti_tpu_torch.spartan.custom_kernels import CUDA_COMBS

    _, k, _, degree = CUDA_COMBS[key]
    per_pair, per_point = CUSTOM_MULS[key]
    return bound(k * 3 * ah * ROW_BYTES, k * ah + degree * ((ah // 2) * per_pair + per_point))


def _field_pool(seed: int) -> tuple:
    """(4,096 canonical SCALAR values drawn from ``seed`` as limbs on the
    card, rand(*shape): rows of it picked on the card)."""
    from otti_tpu_torch.field.ops import SCALAR, ints_to_limbs

    rng = random.Random(seed)
    pool = torch.from_numpy(ints_to_limbs([rng.randrange(SCALAR.modulus) for _ in range(4096)])
                            .reshape(4096, 22)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return pool, lambda *shape: pool[torch.randint(0, 4096, shape, generator=gen, device="cuda")]


def _snark_instances() -> dict:
    """The two SNARK instances of phase snark on the card with their SPARK
    commitments: optdigits 3v8 as the CLI lowers it and the 2^15 R1CS;
    name -> (R1CSDevice, SparkCommitment, vars, inputs)."""
    from otti_tpu_torch import cli
    from otti_tpu_torch.spartan import r1cs, spark

    with open(os.path.join(REPO, "datasets", "SGD", "pmlb-real-extra.json")) as f:
        params = json.load(f)["optdigits"]
    shape, vars_, inputs, _, _ = cli.lower_sgd("optdigits", params)
    big, zvars = r1cs.random_satisfiable(1 << 15, 1 << 15, seed=11)
    out = {}
    for name, sh, v, ins in (("optdigits", shape, vars_, inputs), ("r1cs2p15", big, zvars, [])):
        dev = sh.to_device("cuda")
        comm = spark.commit(dev)
        out[name] = (dev, comm, v, ins)
        log(f"[custom] {name}: {dev.num_cons} constraints, mu_n {comm.mu_n} (entry cube "
            f"2^{comm.mu_n}, 9 tables), mu_x {comm.mu_x}, mu_y {comm.mu_y} (table cubes, 4 "
            f"tables each)")
    return out


# the label of each combination's sumcheck at SPARK's call sites (spark.py)
CUSTOM_LABELS = {"spark_entry4": b"spark/entry", "spark_table": b"spark/row/table"}


def _custom_fs_checks(key: str, n: int, base, consts, cpu_gen) -> None:
    """K5's fused entry == custom_round_fs_plain through a whole sumcheck
    from ``base`` and a random transcript state: the evaluations, the
    tables' active prefix, the state and the challenge after every round,
    then the bare final bind."""
    from otti_tpu_torch.spartan import custom_kernels as CK

    _, k, kc, degree = CK.CUDA_COMBS[key]
    tag = f"K5 fused {key} n=2^{n.bit_length() - 1}"
    mu = n.bit_length() - 1
    prog = CK.round_program(CUSTOM_LABELS[key], degree, "cuda")
    state = torch.randint(0, 256, (200,), generator=cpu_gen, dtype=torch.uint8).cuda()
    t_k, t_p = base.clone(), base.clone()
    s_k, s_p = state.clone(), state.clone()
    e_k, e_p = (torch.empty((mu, degree, 22), dtype=torch.int32, device="cuda") for _ in range(2))
    r_k, r_p = (torch.empty((mu, 22), dtype=torch.int32, device="cuda") for _ in range(2))
    for j in range(mu):
        prev = (r_k[j - 1], n >> j) if j else (None, None)
        CK.custom_round_fs_cuda(t_k, consts, key, degree, s_k, prog, e_k[j], r_k[j], *prev)
        prev = (r_p[j - 1], n >> j) if j else (None, None)
        CK.custom_round_fs_plain(t_p, consts, key, degree, s_p, prog, e_p[j], r_p[j], *prev)
        act = n >> j
        for what, a, b in (("evals", e_k[j], e_p[j]), ("state", s_k, s_p),
                           ("challenge", r_k[j], r_p[j]), ("tables", t_k[:, :act], t_p[:, :act])):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: the {what} differ after round {j}")
    CK.custom_round_cuda(t_k, consts, key, degree, r_k[mu - 1], 1)
    CK.custom_round_plain(t_p, consts, key, degree, r_p[mu - 1], 1)
    if not torch.equal(t_k[:, :1], t_p[:, :1]):
        raise AssertionError(f"{tag}: the final bind differs")


def _custom_checks(rec: dict, shapes: list) -> None:
    """K5 == its plain version through whole sumchecks at ``shapes`` (key,
    n): tables and constants in semi form, the first round, bound rounds
    with the challenge as an int and in device memory in turn (and both
    forms of one value compared), every round down to one pair, the bare
    final bind; evaluations and the tables' active prefix after each round.
    The fused entry likewise against custom_round_fs_plain
    (_custom_fs_checks).  Then one bind + evaluate round at ah = n / 2 (the
    first bind: rows canonicalised) and at ah = n / 4 (rows the kernel
    wrote) timed, bare and fused, against the plain versions and the
    bound; the fused round's extra time at the smallest table round is
    K5's floor (its transcript step in one warp)."""
    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.field.ops import SCALAR
    from otti_tpu_torch.spartan import custom_kernels as CK

    rng = random.Random(9)
    _, rand = _field_pool(9)
    cpu_gen = torch.Generator().manual_seed(9)
    out = {"max_abs_err": 0, "shapes": []}
    for key, n in shapes:
        _, k, kc, degree = CK.CUDA_COMBS[key]
        tag = f"K5 {key} n=2^{n.bit_length() - 1}"
        base = _semi(rand(k * n), cpu_gen).reshape(k, n, 22)
        consts = _semi(rand(kc), cpu_gen)
        rs = [rng.randrange(SCALAR.modulus) for _ in range(n.bit_length() - 1)]
        t_k, t_p = base.clone(), base.clone()
        a = CK.custom_round_cuda(t_k, consts, key, degree)
        b = CK.custom_round_plain(t_p, consts, key, degree)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: first round differs")
        err = int((a - b).abs().max())
        active, j = n, 0
        while active > 1:
            if j == 0:  # the same challenge as an int and in device memory: the same bits
                t_int, t_dev = t_k.clone(), t_k.clone()
                e_int = CK.custom_round_cuda(t_int, consts, key, degree, rs[0], active // 2)
                e_dev = CK.custom_round_cuda(t_dev, consts, key, degree,
                                             F.from_int(SCALAR, rs[0], "cuda"), active // 2)
                if not (torch.equal(t_int, t_dev) and (e_int is None) == (e_dev is None)
                        and (e_int is None or torch.equal(e_int, e_dev))):
                    raise AssertionError(f"{tag}: int and device challenge differ")
                del t_int, t_dev
            r = rs[j]
            if j % 2:  # in device memory, semi form
                r = _semi(F.from_int(SCALAR, r, "cuda")[None], cpu_gen)[0].contiguous()
            a = CK.custom_round_cuda(t_k, consts, key, degree, r, active // 2)
            b = CK.custom_round_plain(t_p, consts, key, degree, r, active // 2)
            active //= 2
            j += 1
            if (a is None) != (active == 1) or (b is None) != (active == 1):
                raise AssertionError(f"{tag}: the bare final bind is the round to 1 row")
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{tag}: evals differ in the round to {active} rows")
            if not torch.equal(t_k[:, :active], t_p[:, :active]):
                raise AssertionError(f"{tag}: tables differ after the round to {active} rows")
            if a is not None:
                err = max(err, int((a - b).abs().max()))
        _custom_fs_checks(key, n, base, consts, cpu_gen)
        torch.cuda.synchronize()
        # timing: a bind + evaluate round, bare and fused, at the first bind
        # (ah = n / 2, rows canonicalised) and at the next (ah = n / 4, rows
        # the kernel wrote)
        r0 = rs[0]
        fs = (torch.zeros(200, dtype=torch.uint8, device="cuda"),
              CK.round_program(CUSTOM_LABELS[key], degree, "cuda"),
              torch.empty((degree, 22), dtype=torch.int32, device="cuda"),
              torch.empty(22, dtype=torch.int32, device="cuda"))

        def times(tabs, ah, suffix=""):
            def bare():
                return CK.custom_round_cuda(tabs, consts, key, degree, r0, ah)

            def fused():
                CK.custom_round_fs_cuda(tabs, consts, key, degree, *fs, r0, ah)

            out = {"ms": cuda_ms(bare, 20, queue_ahead=True),
                   "fs_ms": cuda_ms(fused, 20, queue_ahead=True),
                   "fs_plain_ms": cuda_ms(lambda: CK.custom_round_fs_plain(
                       tabs, consts, key, degree, *fs, r0, ah), 2)}
            if not suffix:
                out.update(wrapper_ms=cuda_ms(bare, 20), fs_wrapper_ms=cuda_ms(fused, 20),
                           plain_ms=cuda_ms(lambda: CK.custom_round_plain(
                               tabs, consts, key, degree, r0, ah), 2))
            return {k + suffix: v for k, v in out.items()}

        row = {"key": key, "n": n, "ah": n // 2, **times(base.clone(), n // 2)}
        if n >= 4:
            tabs = base.clone()
            CK.custom_round_cuda(tabs, consts, key, degree, r0, n // 2)  # rows [0, n / 2) canonical
            row.update(ah_next=n // 4, bound_ms_next=custom_bound(key, n // 4)[0],
                       **times(tabs, n // 4, "_next"))
        row["bound_ms"], row["bound_by"] = custom_bound(key, n // 2)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["shapes"].append(row)
        log(f"[custom] {tag}: {n.bit_length() - 1} rounds and the bare final bind exact "
            f"(challenges as ints and in device memory), the fused entry exact through the "
            f"sumcheck (evaluations, tables, state and challenge every round); a bind+eval "
            f"round at ah=2^{n.bit_length() - 2}: bare {row['ms']:.4f} ms (through the wrapper "
            f"{row['wrapper_ms']:.4f} ms), fused {row['fs_ms']:.4f} ms (wrapper "
            f"{row['fs_wrapper_ms']:.4f}), plain {row['plain_ms']:.3f} ms, fused plain "
            f"{row['fs_plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({100 * row['bound_ms'] / row['ms']:.0f}% of it)"
            + (f"; at ah=2^{n.bit_length() - 3} (rows the kernel wrote): bare "
               f"{row['ms_next']:.4f} ms, fused {row['fs_ms_next']:.4f} ms, fused plain "
               f"{row['fs_plain_ms_next']:.3f} ms, bound {row['bound_ms_next']:.4f} ms"
               if "ms_next" in row else ""))
    # the line's numbers: the largest entry round (the 2^15 instance's), bare
    # and fused (the fused entry is the one the device form runs every round)
    top = max((s for s in out["shapes"] if s["key"] == "spark_entry4"), key=lambda s: s["n"])
    out.update({k: top[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                                    "fs_ms", "fs_wrapper_ms", "fs_plain_ms")})
    low = min((s for s in out["shapes"] if s["key"] == "spark_table"), key=lambda s: s["n"])
    out["floor_ms"] = low["fs_ms"] - low["ms"]
    log(f"[custom] K5's floor: the fused round's extra time over the bare one at "
        f"{low['key']} ah=2^{low['n'].bit_length() - 2}: {out['floor_ms']:.4f} ms (the round's "
        "transcript step, one warp)")
    rec["custom"] = out


def _custom_forms(rec: dict, shapes: list) -> None:
    """prove_custom (a K5 launch and a fetch a round, host transcript) and
    prove_custom_device (SPARK's: every round on the card, one fetch) on the
    same full-width tables: equal rounds, challenges, finals, final claim
    and host transcript afterwards; the rounds verify and the final claim
    is the combination of the finals; warm times of each (median of 3);
    no host sync inside prove_custom_device (OTTI_SYNC_CHECK=1)."""
    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.field.ops import SCALAR
    from otti_tpu_torch.spartan import custom_kernels as CK
    from otti_tpu_torch.spartan import sumcheck as SC
    from otti_tpu_torch.transcript.merlin import Transcript

    pool, rand = _field_pool(10)

    def transcript():  # at the post-challenge offsets, as at SPARK's call sites
        t = Transcript(b"custom smoke")
        t.challenge_vector(b"rho", 2)
        return t

    out = {}
    for key, n in shapes:
        _, k, kc, degree = CK.CUDA_COMBS[key]
        tag = f"{key} n=2^{n.bit_length() - 1}"
        tables = tuple(rand(n) for _ in range(k))
        consts = tuple(pool[:kc])
        comb = CK._COMB_REGISTRY[key]
        claim = F.to_int(SCALAR, F.sum_reduce(SCALAR, comb(consts, tables), axis=0))
        before = [t.clone() for t in tables]
        t_host, t_dev = transcript(), transcript()
        got_host = SC.prove_custom(claim, tables, consts, key, degree, t_host, b"cs")
        got_dev = SC.prove_custom_device(claim, tables, consts, key, degree, t_dev, b"cs")
        if got_host != got_dev:
            raise AssertionError(f"{tag}: prove_custom and prove_custom_device differ")
        if t_host.challenge_scalar(b"after") != t_dev.challenge_scalar(b"after"):
            raise AssertionError(f"{tag}: the host transcripts differ afterwards")
        if not all(torch.equal(a, b) for a, b in zip(before, tables)):
            raise AssertionError(f"{tag}: the caller's tables were changed")
        rounds, rs, finals, e = got_dev
        if SC.verify_custom(claim, rounds, degree, transcript(), b"cs") != (e, rs):
            raise AssertionError(f"{tag}: the rounds do not verify")
        fin = tuple(F.from_ints(SCALAR, [v], "cuda") for v in finals)
        if F.to_int(SCALAR, comb(consts, fin)[0]) != e:
            raise AssertionError(f"{tag}: the final claim is not the combination of the finals")
        times = {}
        for form, fn in (("host", SC.prove_custom), ("device", SC.prove_custom_device)):
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(claim, tables, consts, key, degree, transcript(), b"cs")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            times[form] = _spread(walls)
        out[tag] = {"rounds": len(rounds), "host_s": times["host"], "device_s": times["device"]}
        log(f"[custom] {tag}: prove_custom == prove_custom_device ({len(rounds)} rounds, finals, "
            f"final claim, transcript after), verified; warm prove_custom "
            f"{_show(times['host'])}, prove_custom_device {_show(times['device'])}")
    key, n = shapes[0]
    _, k, kc, degree = CK.CUDA_COMBS[key]
    tables = tuple(rand(n) for _ in range(k))
    os.environ["OTTI_SYNC_CHECK"] = "1"
    try:
        SC.prove_custom_device(0, tables, tuple(pool[:kc]), key, degree, transcript(), b"cs")
        torch.cuda.synchronize()
    finally:
        del os.environ["OTTI_SYNC_CHECK"]
    log(f"[custom] no host sync inside prove_custom_device ({key} n=2^{n.bit_length() - 1}, "
        "OTTI_SYNC_CHECK=1)")
    rec["custom_forms"] = out


def _snark_warm(rec: dict, insts: dict) -> None:
    """SNARK_RUNS warm proves of each instance, with SPARK's sumchecks in each
    form the package has: "device" (prove_custom_device, SPARK's default)
    and "host" (spark made to call prove_custom); median and spread, the
    SPARK stage times, K1-K5 launches of one prove and, for optdigits, the
    device launches and busy share of one under torch.profiler."""
    import otti_tpu_torch
    from otti_tpu_torch import _build, metrics
    from otti_tpu_torch.spartan import snark, sumcheck

    device_form = getattr(sumcheck, "prove_custom_device", None)
    forms = ("device", "host") if device_form else ("host",)
    log(f"[snark_warm] package {os.path.dirname(otti_tpu_torch.__file__)}; forms {forms}")
    for name, (dev, comm, vars_, ins) in insts.items():
        for form in forms:
            if form == "host" and device_form:
                sumcheck.prove_custom_device = sumcheck.prove_custom
            try:
                def fn():
                    return snark.prove(dev, comm, vars_, ins)

                proof = fn()
                if not snark.verify(dev, comm, ins, proof):
                    raise AssertionError(f"{name} ({form}): the SNARK proof does not verify")
                walls, stages = [], collections.defaultdict(list)
                for _ in range(SNARK_RUNS):
                    before = dict(_build.LAUNCHES)
                    metrics.reset()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    for k, v in metrics.snapshot().items():
                        if k.endswith("_s"):
                            stages[k].append(v)
                launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
                prof = _profiled(fn) if name == "optdigits" else None
            finally:
                if device_form:
                    sumcheck.prove_custom_device = device_form
            res = {"s": _spread(walls), "launches": launches, "profile": prof,
                   "stages": {k: _spread(v) for k, v in stages.items()}}
            rec.setdefault("snark_warm", {})[f"{name}:{form}"] = res
            st = res["stages"]
            log(f"[snark_warm] {name} ({form}): warm prove {_show(res['s'])} over {SNARK_RUNS} "
                f"runs; spark_entry_s {_show(st['spark_entry_s'])}, spark_tables_s "
                f"{_show(st['spark_tables_s'])}; every stage's median "
                + json.dumps({k: round(v["median"], 4) for k, v in st.items()})
                + f"; launches {launches}"
                + (f"; profiler: {prof['device_launches']} device launches, "
                   f"{prof['device_ms']:.1f} ms of device time in {prof['profiled_wall_ms']:.1f} "
                   f"ms ({100 * prof['busy_share']:.1f}% busy), hand-written kernels' ms "
                   + json.dumps({k: round(v, 3) for k, v in prof["own_kernels_ms"].items()})
                   if prof else ""))


def phase_snark_warm(rec: dict) -> None:
    """The warm SNARK proves of phase custom alone (with ``--tree``, another
    commit's package in the same call)."""
    _snark_warm(rec, _snark_instances())


def phase_custom(rec: dict) -> None:
    """SPARK's custom sumchecks: K5 against its plain version and
    prove_custom against prove_custom_device at the SNARK instances' full
    widths, then the warm SNARK proves."""
    t0 = time.time()
    insts = _snark_instances()
    shapes = []
    for _, comm, _, _ in insts.values():
        for key, mu in (("spark_entry4", comm.mu_n), ("spark_table", comm.mu_x),
                        ("spark_table", comm.mu_y)):
            if mu and (key, 1 << mu) not in shapes:
                shapes.append((key, 1 << mu))
    shapes.sort(key=lambda s: (s[0] != "spark_entry4", -s[1]))
    log(f"[custom] instances lowered and committed in {time.time() - t0:.1f}s; shapes {shapes}")
    t0 = time.time()
    _custom_checks(rec, shapes)
    log(f"[custom] K5 held and timed in {time.time() - t0:.1f}s")
    t0 = time.time()
    _custom_forms(rec, shapes)
    log(f"[custom] the two forms compared in {time.time() - t0:.1f}s")
    _snark_warm(rec, insts)


# Keccak-f[1600], 32-bit integer operations a state: 24 rounds of theta (20
# XORs for the column parities, 5 x (rotation: 3 + XOR) for D, 25 XORs),
# rho + pi (24 rotations of 3), chi (25 x NOT, AND, XOR) and iota (1), each
# 64-bit operation two 32-bit ones.
KECCAK_OPS = 2 * 24 * (20 + 5 * 4 + 25 + 24 * 3 + 25 * 3 + 1)
# BASE multiplies of one ristretto encoding (csrc/ristretto.cuh): u1, u2,
# u2^2, u1 u2^2; v^2, v^3, v3^2, v^7; the chain (251 squarings, 11
# multiplies); v3 * chain, r^2, v r^2, -u i, r i; den1, den2, den1 den2,
# * T, ix, iy, enchanted, T z_inv, Xr z_inv, s.  The bound counts each as a
# full multiply (WIDE_MULS["base"]): the least time for the function,
# whatever squaring trick an implementation uses.
ENCODE_MULS = 4 + 4 + 262 + 5 + 10
ENCODE_SQUARES = 255  # of those, squarings: u2^2, v^2, v3^2, r^2 and the chain's 251


def ops_bound(n_ops: float, n_bytes: float) -> tuple:
    """(least ms, what sets it): n_ops 32-bit integer operations at the
    integer rate against n_bytes at the memory rate."""
    t_ops = n_ops / INT32_MADS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Measurement probes on ristretto.cuh and keccak.cuh (not a kernel of any
# path): an empty kernel, one square between a load and a store (its SASS
# is counted), chains of dependent squarings and multiplies in one thread
# and of permutations in one warp, whose time a step is that step's
# critical path.
PROBE_CU = r"""
#include "ristretto.cuh"
#include "keccak.cuh"

__device__ __forceinline__ Fe ld(const uint32_t* p) {
  Fe a;
  for (int i = 0; i < 8; ++i) a.w[i] = p[i];
  return a;
}
__device__ __forceinline__ void st(uint32_t* p, const Fe& a) {
  for (int i = 0; i < 8; ++i) p[i] = a.w[i];
}
extern "C" __global__ void probe_empty() {}
extern "C" __global__ void probe_io(uint32_t* x) { st(x, ld(x)); }
extern "C" __global__ void probe_sq_full(uint32_t* x) {
  const Fe a = ld(x);
  st(x, fe_mul<FIELD_BASE>(a, a));
}
extern "C" __global__ void probe_sq_loose(uint32_t* x) { st(x, fe_sq_loose(ld(x))); }
extern "C" __global__ void probe_mul_loose(uint32_t* x) { st(x, fe_mul_loose(ld(x), ld(x + 8))); }
// OP 0: a = a^2 (fe_mul), 1: a = a^2 (fe_sq_loose), 2: a = a b (fe_mul), 3: a = a b (fe_mul_loose)
template <int OP>
__global__ void probe_chain(uint32_t* x, int n, int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe a = ld(x + 16 * i);
  const Fe b = ld(x + 16 * i + 8);
#pragma unroll 4
  for (int r = 0; r < reps; ++r)
    a = OP == 0 ? fe_mul<FIELD_BASE>(a, a) : OP == 1 ? fe_sq_loose(a)
      : OP == 2 ? fe_mul<FIELD_BASE>(a, b) : fe_mul_loose(a, b);
  st(x + 16 * i, fe_canon<FIELD_BASE>(a));
}
__global__ void probe_keccak_chain(uint64_t* s, int reps) {  // one warp, one state
  const int lane = threadIdx.x & 31, t = lane < KECCAK_LANES ? lane : 0;
  KeccakWarp w;
  w.src = keccak_sources(t);
  w.t = t;
  uint64_t a = s[t];
  for (int r = 0; r < reps; ++r) a = keccak_rounds(w, a);
  if (lane < KECCAK_LANES) s[t] = a;
}
// The alternative to K3's one warp a state: one thread a state, the 25 lanes
// in registers, pi a renaming (the rounds written out), the pad in the launch.
__device__ __forceinline__ uint64_t rl(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}
__global__ void probe_keccak_thread(uint64_t* st, long long n, int pos, int pos_begin) {
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  if (i >= n) return;
  uint64_t* s = st + 25 * i;
  uint64_t A[25], B[25], C[5], D[5];
#pragma unroll
  for (int l = 0; l < 25; ++l) A[l] = s[l] ^ strobe_pad_lane(l, pos, pos_begin);
  const int rot[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
                       41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
#pragma unroll
  for (int r = 0; r < 24; ++r) {
#pragma unroll
    for (int x = 0; x < 5; ++x) C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) D[x] = C[(x + 4) % 5] ^ rl(C[(x + 1) % 5], 1);
#pragma unroll
    for (int l = 0; l < 25; ++l)  // lane (x, y) goes to (y, 2x + 3y)
      B[l / 5 + 5 * ((2 * (l % 5) + 3 * (l / 5)) % 5)] = rl(A[l] ^ D[l % 5], rot[l]);
#pragma unroll
    for (int l = 0; l < 25; ++l)
      A[l] = B[l] ^ (~B[5 * (l / 5) + (l + 1) % 5] & B[5 * (l / 5) + (l + 2) % 5]);
    A[0] ^= KECCAK_RC[r];
  }
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = A[l];
}
extern "C" int probe_keccak_thread_launch(void* st, long long n, int pos, int pos_begin,
                                          void* stream) {
  probe_keccak_thread<<<(unsigned)((n + 31) / 32), 32, 0, (cudaStream_t)stream>>>(
      (uint64_t*)st, n, pos, pos_begin);
  return (int)cudaGetLastError();
}
extern "C" int probe_init(const int32_t* consts) {
  const int err = set_field_consts(consts);
  return err ? err : set_ristretto_consts(reinterpret_cast<const uint32_t*>(consts) + 26);
}
// which 0: the empty kernel; 1: probe_chain<op> over n threads; 2: the Keccak chain
extern "C" int probe_launch(int which, void* x, int n, int reps, int op, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* p = (uint32_t*)x;
  const int blocks = (n + 31) / 32;
  if (which == 0) probe_empty<<<1, 32, 0, s>>>();
  else if (which == 2) probe_keccak_chain<<<1, 32, 0, s>>>((uint64_t*)x, reps);
  else if (op == 0) probe_chain<0><<<blocks, 32, 0, s>>>(p, n, reps);
  else if (op == 1) probe_chain<1><<<blocks, 32, 0, s>>>(p, n, reps);
  else if (op == 2) probe_chain<2><<<blocks, 32, 0, s>>>(p, n, reps);
  else probe_chain<3><<<blocks, 32, 0, s>>>(p, n, reps);
  return (int)cudaGetLastError();
}
"""


def _build_probes() -> dict:
    """PROBE_CU compiled twice, side by side: with the device's PTX carry
    chains and with the portable C++ of the same arithmetic (OTTI_NO_PTX).
    {variant: (ctypes library, {function: SASS instructions})}."""
    import ctypes

    from otti_tpu_torch import _build

    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    tmp = tempfile.mkdtemp(prefix="otti_probe_")
    src = os.path.join(tmp, "probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_CU)
    procs = {}
    for variant, extra in (("ptx", []), ("portable", ["-DOTTI_NO_PTX"])):
        lib = os.path.join(tmp, f"probe_{variant}.so")
        procs[variant] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, *extra, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    fn_re = re.compile(r"Function : (\w+)")
    op_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    for variant, (lib, proc) in procs.items():
        o, e = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"probe build ({variant}) failed:\n{o}\n{e}")
        dll = ctypes.CDLL(lib)
        dll.probe_init.argtypes = [ctypes.c_void_p]
        dll.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        dll.probe_keccak_thread_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_void_p]
        consts = np.ascontiguousarray(_build.ristretto_consts())
        _build.check(dll.probe_init(consts.ctypes.data), "probe_init")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = fn_re.search(line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn:
                m = op_re.search(line)
                if m and m.group(1) != "NOP":
                    counts[fn] += 1
        out[variant] = (dll, counts)
    return out


def _probe_chains(rec: dict) -> dict:
    """The probes' numbers: SASS instructions of one square (old and new),
    ns a step of each dependent chain in one thread (and a square at 4,096
    threads), one permutation's chain, and the empty kernel's time."""
    from otti_tpu_torch import _build

    probes = _build_probes()
    res = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for variant, (dll, counts) in probes.items():
        io = counts.get("probe_io", 0)
        sass = {k: counts.get(k, 0) - io for k in ("probe_sq_full", "probe_sq_loose",
                                                   "probe_mul_loose")}
        log(f"[device_fs:probe:{variant}] SASS instructions beyond the load and store "
            f"({io}): one fe_mul square {sass['probe_sq_full']}, one fe_sq_loose "
            f"{sass['probe_sq_loose']}, one fe_mul_loose {sass['probe_mul_loose']}")
        rng = np.random.default_rng(5)
        reps = 2048
        chain = {}
        for n in (1, 4096):
            x0 = torch.from_numpy(rng.integers(0, 2**32, (n, 16), dtype=np.uint32)
                                  .view(np.int32)).cuda()
            outs = {}
            for op in (0, 1, 2, 3) if n == 1 else (0, 1):
                x = x0.clone()
                run = lambda: _build.check(  # noqa: E731
                    dll.probe_launch(1, x.data_ptr(), n, reps, op, stream()), "probe_chain")
                run()
                torch.cuda.synchronize()
                outs[op] = x[:, :8].clone()
                chain[(n, op)] = cuda_ms(run, 5) * 1e6 / reps
            if not (torch.equal(outs[0], outs[1]) and (n > 1 or torch.equal(outs[2], outs[3]))):
                raise AssertionError(f"probe ({variant}): loose and full chains differ at n={n}")
        st = torch.from_numpy(rng.integers(0, 256, (1, 200), dtype=np.uint8)).cuda()
        perm_ns = cuda_ms(lambda: dll.probe_launch(2, st.data_ptr(), 1, 512, 0, stream()), 5) \
            * 1e6 / 512
        empty_ms = cuda_ms(lambda: dll.probe_launch(0, 0, 1, 0, 0, stream()), 200,
                           queue_ahead=True)
        res[variant] = {"sass": sass, "sass_io": io, "perm_ns": perm_ns, "empty_ms": empty_ms,
                        "sq_full_ns": chain[(1, 0)], "sq_loose_ns": chain[(1, 1)],
                        "mul_full_ns": chain[(1, 2)], "mul_loose_ns": chain[(1, 3)],
                        "sq_full_ns_4096": chain[(4096, 0)],
                        "sq_loose_ns_4096": chain[(4096, 1)]}
        log(f"[device_fs:probe:{variant}] one thread, a step of a chain of {reps}: square "
            f"{chain[(1, 0)]:.2f} ns by fe_mul, {chain[(1, 1)]:.2f} ns by fe_sq_loose; multiply "
            f"{chain[(1, 2)]:.2f} ns by fe_mul, {chain[(1, 3)]:.2f} ns by fe_mul_loose; 4,096 "
            f"threads: square {chain[(4096, 0)]:.3f} / {chain[(4096, 1)]:.3f} ns a step; one "
            f"warp's Keccak-f[1600] {perm_ns:.1f} ns; empty kernel {empty_ms:.5f} ms")
    rec["probe"] = res
    return {**res["ptx"], "dll": probes["ptx"][0]}


def _timed(fn, plain, reps: int = 50, plain_reps: int = 2) -> tuple:
    """(kernel ms behind the spin kernel, through the wrapper, plain ms)."""
    return (cuda_ms(fn, reps, queue_ahead=True), cuda_ms(fn, reps), cuda_ms(plain, plain_reps))


def _dfs_kernels(rec: dict, rows: int) -> None:
    """K3 (with and without the pad), K4 at the main path's sizes (``rows``:
    the optdigits witness commitment's) and kernel 2 fed a challenge from
    device memory, each against its plain version (and K3, K4 against the
    host library), bit for bit; their times beside the bound and the
    critical-path floor."""
    from otti_tpu_torch import _build, native
    from otti_tpu_torch.curve import edwards as E
    from otti_tpu_torch.curve import ristretto
    from otti_tpu_torch.field.ops import SCALAR, ints_to_limbs
    from otti_tpu_torch.msm import pippenger
    from otti_tpu_torch.spartan import sumcheck_kernels as SK
    from otti_tpu_torch.spartan.nizk import GENS_LABEL
    from otti_tpu_torch.transcript import device as D

    probe = _probe_chains(rec)
    rng = np.random.default_rng(9)

    def host_f(state: bytes, pos: int, pos_begin: int) -> bytes:
        h = bytearray(state)
        if pos >= 0:
            h[pos] ^= pos_begin
            h[pos + 1] ^= 0x04
            h[D._RATE + 1] ^= 0x80
        native.keccak_f1600(h)
        return bytes(h)

    # ---- K3: a chain of 64 permutations of one state, every other one padded
    # at a moving position (the transcript's calls), then 4,096 states
    st = torch.from_numpy(rng.integers(0, 256, (1, 200), dtype=np.uint8)).cuda()
    k_st, p_st, host = st.clone(), st.clone(), st.cpu().numpy().tobytes()
    for i in range(64):
        pos, pos_begin = (-1, 0) if i % 2 == 0 else ((37 * i) % (D._RATE + 1), (11 * i) % 256)
        D.keccak_f1600_cuda(k_st, pos, pos_begin)
        p_st = D.keccak_f1600_plain(p_st, pos, pos_begin)
        if i < 8:
            host = host_f(host, pos, pos_begin)
            if k_st.cpu().numpy().tobytes() != host:
                raise AssertionError(f"K3 differs from the host permutation at step {i}")
        if not torch.equal(k_st, p_st):
            raise AssertionError(f"K3 differs from its plain version at step {i} of the chain")
    big = torch.from_numpy(rng.integers(0, 256, (4096, 200), dtype=np.uint8)).cuda()
    for pos, pos_begin in ((-1, 0), (166, 77)):
        k_big = D.keccak_f1600_cuda(big.clone(), pos, pos_begin)
        if not torch.equal(k_big, D.keccak_f1600_plain(big, pos, pos_begin)):
            raise AssertionError(f"K3 differs from its plain version on 4,096 states (pad {pos})")
        for i in (0, 1, 4095):
            if k_big[i].cpu().numpy().tobytes() != host_f(big[i].cpu().numpy().tobytes(), pos,
                                                          pos_begin):
                raise AssertionError(f"K3 differs from the host permutation at state {i}")
    floor3 = probe["empty_ms"] + probe["perm_ns"] * 1e-6
    sizes = {}
    for tag, b, pad in (("one", 1, (-1, 0)), ("one_pad", 1, (64, 21)), ("b4096", 4096, (-1, 0))):
        x = st.clone() if b == 1 else big.clone()
        t_k, t_w, t_p = _timed(lambda: D.keccak_f1600_cuda(x, *pad),
                               lambda: D.keccak_f1600_plain(x, *pad), plain_reps=3)
        b_ms, b_by = ops_bound(b * KECCAK_OPS, b * 400)
        y = x.clone()  # the alternative design, one thread a state (PROBE_CU)
        alt = lambda: _build.check(probe["dll"].probe_keccak_thread_launch(  # noqa: E731
            y.data_ptr(), b, *pad, torch.cuda.current_stream().cuda_stream), "probe_keccak_thread")
        alt()
        if not torch.equal(y, D.keccak_f1600_plain(x, *pad)):
            raise AssertionError("the one-thread Keccak probe differs from the plain version")
        t_alt = cuda_ms(alt, 50, queue_ahead=True)
        sizes[tag] = {"ms": t_k, "wrapper_ms": t_w, "plain_ms": t_p, "bound_ms": b_ms,
                      "bound_by": b_by, "floor_ms": floor3, "one_thread_ms": t_alt}
        log(f"[device_fs] K3 {tag} (B={b}, pad {pad}): kernel {t_k:.5f} ms (through the "
            f"wrapper {t_w:.5f} ms), plain {t_p:.4f} ms, bound {b_ms:.7f} ms by {b_by}; "
            f"critical-path floor {floor3:.5f} ms (empty kernel + one warp's permutation); one "
            f"thread a state instead of one warp: {t_alt:.5f} ms")
    rec["keccak"] = {"max_abs_err": 0, **sizes["one_pad"], "sizes": sizes}
    log("[device_fs] K3 == plain over a chain of 64 permutations (32 padded) and on 4,096 "
        "states with and without the pad; == the host library on 14 states")

    # ---- K4: the identity, comb-table points (z = 1) and device sums
    tbl = pippenger.fixed_base_tables(4, GENS_LABEL, True, "cuda")["p"]
    gen = torch.Generator().manual_seed(4)

    def points(n):
        idx = torch.randint(0, tbl.shape[0], (2, n), generator=gen).cuda()
        a, b = E.from_affine_pack(tbl[idx[0]]), E.from_affine_pack(tbl[idx[1]])
        s_ab = E.add(a, b)  # general z and t
        pts = E.tree_map(lambda x, y: torch.cat([x[: n // 2], y[n // 2 :]]), a, s_ab)
        ident = E.identity((1,), "cuda")
        return E.tree_map(lambda x, y: torch.cat([y, x[1:]]).contiguous(), pts, ident)

    # the chain: the squarings, the other multiplies (fe_mul_loose's chain step
    # stands for each; the few canonicalisations are left out)
    floor4 = probe["empty_ms"] + 1e-6 * (ENCODE_SQUARES * probe["sq_loose_ns"]
                                         + (ENCODE_MULS - ENCODE_SQUARES) * probe["mul_loose_ns"])
    sizes = {}
    for n in sorted({1, 2, 11, rows, 4096}):
        pts = points(n)
        got, want = ristretto.encode_cuda(pts), ristretto.encode_plain(pts)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 differs from its plain version at n={n}")
        refs = E.to_refs(E.tree_map(lambda a: a[:64], pts))
        host = [native.ristretto_encode_host(q) for q in refs]
        if [bytes(r.tolist()) for r in got[:64].cpu()] != host:
            raise AssertionError(f"K4 differs from the host library at n={n}")
        if host[0] != bytes(32):
            raise AssertionError("the identity does not encode to 32 zero bytes")
        t_k, t_w, t_p = _timed(lambda: ristretto.encode_cuda(pts),
                               lambda: ristretto.encode_plain(pts), reps=30)
        b_ms, b_by = ops_bound(n * ENCODE_MULS * 2 * WIDE_MULS["base"], n * (4 * ROW_BYTES + 32))
        sizes[f"n{n}"] = {"ms": t_k, "wrapper_ms": t_w, "plain_ms": t_p, "bound_ms": b_ms,
                          "bound_by": b_by, "floor_ms": floor4}
        log(f"[device_fs] K4 n={n}{' (witness rows)' if n == rows else ''}: kernel {t_k:.5f} ms "
            f"(through the wrapper {t_w:.5f} ms), plain {t_p:.3f} ms, bound {b_ms:.6f} ms by "
            f"{b_by}; critical-path floor {floor4:.5f} ms")
    rec["ristretto"] = {"max_abs_err": 0, **sizes["n2"], "sizes": sizes}
    log(f"[device_fs] K4 == plain == host library at n = 1, 2, 11, {rows}, 4,096 (identity, "
        "comb points, device sums)")

    # ---- kernel 2 with the challenge in device memory == with it as an int
    M = SCALAR.modulus
    pyr = random.Random(6)
    n = 1 << 15
    for degree in (3, 2):
        k = 4 if degree == 3 else 2
        base = [torch.from_numpy(ints_to_limbs([pyr.randrange(M) for _ in range(n)])
                                 .reshape(n, 22)).cuda() for _ in range(k)]
        rs = [pyr.randrange(M) for _ in range(n.bit_length())]
        rs_dev = [torch.from_numpy(ints_to_limbs([r]).reshape(22)).cuda() for r in rs]
        t_int, t_dev = [t.clone() for t in base], [t.clone() for t in base]
        ev_i, sn_i = _run_sumcheck(SK.sumcheck_round_cuda, t_int, degree, rs)
        ev_d, sn_d = _run_sumcheck(SK.sumcheck_round_cuda, t_dev, degree, rs_dev)
        same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(ev_i, ev_d))
        same = same and all(torch.equal(x, y) for sa, sb in zip(sn_i, sn_d) for x, y in zip(sa, sb))
        if not same:
            raise AssertionError(f"kernel 2 (degree {degree}): device challenge != int challenge")
        small = [t[:64].clone() for t in base]
        small2 = [t.clone() for t in small]
        ev_p, sn_p = _run_sumcheck(SK.sumcheck_round_plain, small, degree, rs_dev)
        ev_k, sn_k = _run_sumcheck(SK.sumcheck_round_cuda, small2, degree, rs_dev)
        if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(ev_p, ev_k)):
            raise AssertionError(f"kernel 2 (degree {degree}): device challenge, kernel != plain")
        if degree == 3:
            tabs = [t.clone() for t in base]
            t_dev_ms = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, 3, rs_dev[0], n // 2), 50,
                               queue_ahead=True)
            t_int_ms = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, 3, rs[0], n // 2), 50,
                               queue_ahead=True)
            rec["kernel2_device_challenge"] = {"ms": t_dev_ms, "int_ms": t_int_ms}
            log(f"[device_fs] kernel 2 cubic bind+eval round at 2^15, challenge in device "
                f"memory {t_dev_ms:.4f} ms, as an int {t_int_ms:.4f} ms")
    log("[device_fs] kernel 2 with the challenge in device memory == with it as an int, "
        "cubic and quadratic, 2^15 rows down to the final bind; == plain at 64 rows")


def _dfs_instances(tmp: str, names=("optdigits", "iris", "lp117x225")) -> dict:
    """optdigits 3v8 (2^13: hybrid), iris 0v1 (2^10: fused) and the LP
    117 x 225 written from a seed (2^14: hybrid), lowered (those of
    ``names``)."""
    from otti_tpu_torch import cli
    from otti_tpu_torch.codegen import lp_cert
    from otti_tpu_torch.io import mps
    from otti_tpu_torch.oracle import lp_oracle

    with open(os.path.join(REPO, "datasets", "SGD", "pmlb-real-extra.json")) as f:
        optdigits = json.load(f)["optdigits"]
    out = {}
    for name, params in (("optdigits", optdigits), ("iris", IRIS)):
        if name in names:
            shape, vars_, inputs, _, _ = cli.lower_sgd(name, params)
            out[name] = (shape, vars_, inputs)
    if "lp117x225" not in names:
        return out
    path = os.path.join(tmp, "gen117x225.mps")
    write_lp_mps(path, 117, 225, seed=1)
    prob = mps.parse_mps(path)
    x, y, _ = lp_oracle.solve(prob)
    out["lp117x225"] = lp_cert.build(prob, x, y)
    return out


def _dfs_proofs(rec: dict, insts: dict, tmp: str) -> None:
    """The device-transcript provers against the host-transcript ones, byte
    for byte with one blind seed, through the CLI's choice; verification,
    tampering, the sync check, the launch counts, cold and warm times."""
    from otti_tpu_torch import _build, cli, metrics
    from otti_tpu_torch.spartan import fused, hybrid, nizk, serial, zkfused, zknizk

    seed = bytes(range(32))
    for name, (shape, vars_, inputs) in insts.items():
        dev = shape.to_device("cuda")
        prove_zk, verify_zk, classic = cli._provers(shape, True, "otti")
        want = {"optdigits": hybrid.prove_zk, "iris": zkfused.prove,
                "lp117x225": hybrid.prove_zk}[name]
        if prove_zk is not want or classic:
            raise AssertionError(f"{name}: the CLI chose {prove_zk.__module__}")
        times = {}
        # "first": the first prove of this shape in the process only when the
        # phase runs alone (phase main proves optdigits and iris before it)
        for capture in ("first", "again"):
            for tag, fn in (("device_fs", prove_zk), ("classic", zknizk.prove)):
                metrics.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                proof = fn(dev, vars_, inputs, seed=seed)
                torch.cuda.synchronize()
                t_prove = time.perf_counter() - t0
                snap = {k: round(v, 4) for k, v in metrics.snapshot().items()}
                t0 = time.perf_counter()
                ok = verify_zk(dev, inputs, proof)
                t_verify = time.perf_counter() - t0
                if not ok:
                    raise AssertionError(f"{name} {tag} zk proof does not verify")
                times[(tag, capture)] = (serial.dumps(proof), t_prove, t_verify)
                log(f"[device_fs:{name}] zk {tag} {capture}: prove {t_prove:.4f}s verify "
                    f"{t_verify:.4f}s, {shape.num_cons} constraints, proof "
                    f"{proof.size_bytes()} B; prover {json.dumps(snap)}")
                rec.setdefault("device_fs", {})[f"{name}:zk:{tag}:{capture}"] = {
                    "prove_s": t_prove, "verify_s": t_verify, **snap}
        dfs = {times[("device_fs", c)][0] for c in ("first", "again")}
        cls = {times[("classic", c)][0] for c in ("first", "again")}
        if len(dfs) != 1 or dfs != cls:
            raise AssertionError(f"{name}: device-transcript and classic zk proofs differ")
        proof = serial.loads(times[("device_fs", "again")][0])
        bad = dataclasses.replace(proof, bullet=dataclasses.replace(
            proof.bullet, z1=(proof.bullet.z1 + 1) % zknizk.L))
        if verify_zk(dev, inputs, bad):
            raise AssertionError(f"{name}: a zk proof with a tampered bullet.z1 verified")
        plain = serial.dumps(nizk.prove(dev, vars_, inputs))
        for tag, fn in (("hybrid", hybrid.prove), ("fused", fused.prove)):
            p = fn(dev, vars_, inputs)
            if serial.dumps(p) != plain or not nizk.verify(dev, inputs, p):
                raise AssertionError(f"{name}: {tag}.prove differs from nizk.prove")
        # no host sync between the two transfers (warm: tables and constants
        # are there), and the launches of that warm zk prove
        before = dict(_build.LAUNCHES)
        os.environ["OTTI_SYNC_CHECK"] = "1"
        try:
            prove_zk(dev, vars_, inputs, seed=seed)
            torch.cuda.synchronize()
            per = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            cli._provers(shape, False, "otti")[0](dev, vars_, inputs)
            torch.cuda.synchronize()
        finally:
            del os.environ["OTTI_SYNC_CHECK"]
        rec.setdefault("launches_per_prove", {})[f"zk-device_fs:{name}"] = per
        log(f"[device_fs:{name}] device-transcript and classic zk proofs byte-equal "
            f"(seeded), fused and hybrid plain == nizk, tampered bullet.z1 rejected, "
            f"no host sync between the two transfers (OTTI_SYNC_CHECK, zk and plain); "
            f"launches of a warm zk prove {per}")
        if name == "optdigits":  # stage by stage, from CUDA events (hybrid._stage)
            metrics.reset()
            prove_zk(dev, vars_, inputs, seed=seed)
            dev_s = {k: round(v, 6) for k, v in metrics.snapshot().items()
                     if k.endswith("_dev_s")}
            if not dev_s:
                raise AssertionError(f"[device_fs:{name}] a zk prove left no <stage>_dev_s")
            log(f"[device_fs:{name}] warm zk prove, device time by stage: " + json.dumps(dev_s))
            on, off = _stage_event_cost(lambda: prove_zk(dev, vars_, inputs, seed=seed))
            rec["stage_event_cost"] = {"on_s": on, "off_s": off}
            log(f"[device_fs:{name}] warm zk prove with the stage events "
                f"{statistics.median(on):.4f}s, without {statistics.median(off):.4f}s (medians "
                f"of {len(on)}, alternated; on {[round(t, 4) for t in on]}, off "
                f"{[round(t, 4) for t in off]})")

    # through the CLI under OTTI_CLASSIC=1, cold then warm (phase main drives
    # the default, the device transcript), then run_lp by default
    cfg = os.path.join(tmp, "smoke.json")
    _config(cfg)
    os.environ["OTTI_CLASSIC"] = "1"
    try:
        _drive_run_sgd(rec, "classic", cfg, os.path.join(tmp, "cls"), ("optdigits", "iris"),
                       "zk-classic", kernels=HOST_FS_KERNELS, zk=True)
    finally:
        del os.environ["OTTI_CLASSIC"]
    lp = os.path.join(tmp, "gen117x225.mps")
    _zero_launches()
    for capture in ("cold", "warm"):
        ok, _ = _captured(f"device_fs:lp:{capture}", cli.run_lp, [lp], os.path.join(tmp, "lp"),
                          zk=True)
        if not ok:
            raise AssertionError(f"LP 117 x 225 ({capture}) did not verify")
        _check_meta(f"device_fs:lp:{capture}",
                    os.path.join(tmp, "lp", "LP", "gen117x225.mps.meta.json"), "zk")
    rec["launches_device_fs"] = _read_launches("device_fs:lp", ZK_KERNELS)


def _dfs_fused_pad(rec: dict, inst: tuple) -> None:
    """A warm optdigits zk prove by the CLI's pick under torch.profiler,
    with the STROBE pad applied as a torch XOR before each permutation (as
    DeviceStrobe._run_f did before the pad went into K3) and fused into K3:
    device launches, K3's and K4's device time, the two proofs byte-equal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from otti_tpu_torch import cli
    from otti_tpu_torch.spartan import serial
    from otti_tpu_torch.transcript import device as D

    shape, vars_, inputs = inst
    dev = shape.to_device("cuda")
    prove = cli._provers(shape, True, "otti")[0]
    seed = bytes(range(32))

    def run_f_unfused(self):
        self.state ^= D._pad_bytes(self.pos, self.pos_begin, self.state.device)
        D.keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    run_f_fused = D.DeviceStrobe._run_f
    proofs, res = {}, {}
    try:
        for tag, run_f in (("unfused", run_f_unfused), ("fused", run_f_fused)):
            D.DeviceStrobe._run_f = run_f
            prove(dev, vars_, inputs, seed=seed)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                proofs[tag] = serial.dumps(prove(dev, vars_, inputs, seed=seed))
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and getattr(e, "device_time_total", 0) > 0]
            own = {k: sum(e.self_device_time_total for e in events if k in e.key) / 1e3
                   for k in ("keccak_kernel", "ristretto_encode_kernel")}
            res[tag] = {"device_launches": sum(e.count for e in events),
                        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
                        "k3_ms": own["keccak_kernel"], "k4_ms": own["ristretto_encode_kernel"]}
            log(f"[device_fs:pad] warm optdigits zk prove, pad {tag}: "
                f"{res[tag]['device_launches']} device launches, {res[tag]['device_ms']:.1f} ms "
                f"of device time; K3 {res[tag]['k3_ms']:.3f} ms, K4 {res[tag]['k4_ms']:.3f} ms")
    finally:
        D.DeviceStrobe._run_f = run_f_fused
    if proofs["unfused"] != proofs["fused"]:
        raise AssertionError("the fused pad changed the optdigits zk proof")
    rec["fused_pad"] = res
    fewer = res["unfused"]["device_launches"] - res["fused"]["device_launches"]
    log(f"[device_fs:pad] fused pad: {fewer} fewer device launches a warm optdigits zk prove, "
        "proofs byte-equal")


STAGE_EVENT_RUNS = 12  # warm proves timed with hybrid._stage's events, and as many without


def _stage_event_cost(prove) -> tuple:
    """Walls (s) of warm prove()s with the stage events and without (no
    ``hybrid._collect`` open, so no ``_stage`` records one), in the order
    on, off, off, on, ...: (on, off)."""
    from otti_tpu_torch.spartan import hybrid

    @contextlib.contextmanager
    def no_collection():
        yield []

    real, walls = hybrid._collect, ([], [])
    for i in range(2 * STAGE_EVENT_RUNS):
        on = i % 4 in (0, 3)
        hybrid._collect = real if on else no_collection
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prove()
            torch.cuda.synchronize()
            walls[not on].append(time.perf_counter() - t0)
        finally:
            hybrid._collect = real
    return walls


def phase_device_fs(rec: dict) -> None:
    """The device transcript: kernels K3 and K4 (with the measurement
    probes) and kernel 2's device challenge, then the device-transcript
    provers the CLI picks by default, then the fused pad's launches."""
    from otti_tpu_torch.spartan.nizk import _hyrax_dims

    with tempfile.TemporaryDirectory() as tmp:
        insts = _dfs_instances(tmp)
        rows = 1 << _hyrax_dims(insts["optdigits"][0].num_vars_padded)[0]
        log(f"[device_fs] optdigits: witness commitment of {rows} rows")
        _dfs_kernels(rec, rows)
        _dfs_proofs(rec, insts, tmp)
        _dfs_fused_pad(rec, insts["optdigits"])


def _profile_prove(rec: dict, tag: str, prove, covered: set, host_ops: bool = True) -> None:
    """One warm prove with the multiply wrapper's calls written down (launch
    sizes, kernel == plain at each shape not in ``covered``, the time at the
    three that multiply most rows), then torch.profiler over another: device
    kernels, and with ``host_ops`` the host's operators too (a SNARK prove
    makes ten times the launches, and tracing its host side takes a minute)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from otti_tpu_torch import _build
    from otti_tpu_torch.field import kernels as K
    from otti_tpu_torch.field.ops import BASE, SCALAR

    prove()  # warm: comb table built
    torch.cuda.synchronize()
    sizes: dict = {}
    real_mul = K.mul_cuda

    def recording_mul(spec, a, b):
        key = (spec.kind, a.numel() // 22, b.dim() == 1)
        sizes[key] = sizes.get(key, 0) + 1
        return real_mul(spec, a, b)

    before = dict(_build.LAUNCHES)
    K.mul_cuda = recording_mul
    try:
        prove()
        torch.cuda.synchronize()
    finally:
        K.mul_cuda = real_mul
    per_prove = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    rec.setdefault("launches_per_prove", {})[tag] = per_prove
    log(f"[profile:{tag}] launches of one warm optdigits prove: {per_prove}")
    gen = torch.Generator().manual_seed(3)
    for kind in ("scalar", "base"):
        rows = sorted(((c, n, sh) for (k, n, sh), c in sizes.items() if k == kind),
                      key=lambda t: -t[0] * t[1])  # by rows multiplied in the prove
        log(f"[profile:{tag}] kernel1 {kind} launch sizes (rows: launches): "
            + ", ".join(f"{n}{'*' if sh else ''}: {c}" for c, n, sh in rows)
            + "  (*: shared operand)")
        spec = SCALAR if kind == "scalar" else BASE
        held = 0
        for rank, (c, n, sh) in enumerate(rows):
            new = (kind, n, sh) not in covered
            if not new and rank >= 3:
                continue
            x = torch.randint(0, 4096, (n, 22), generator=gen, dtype=torch.int32)
            x[:, 21] = 0
            x = _semi(x.cuda(), gen)
            y = x[0].contiguous() if sh else x.flip(0).contiguous()
            if new:
                if not torch.equal(real_mul(spec, x, y), K.mul_plain(spec, x, y)):
                    raise AssertionError(
                        f"kernel1 {kind}: kernel and plain differ at the prover's launch size "
                        f"n={n}{' shared' if sh else ''}")
                covered.add((kind, n, sh))
                held += 1
            if rank >= 3:  # timed: the three sizes that multiply most rows in a prove
                continue
            t_k = cuda_ms(lambda: real_mul(spec, x, y), 50, queue_ahead=True)
            t_p = cuda_ms(lambda: K.mul_plain(spec, x, y), 3)
            b_ms, b_by = mul_bound(kind, n, sh)
            log(f"[profile:{tag}] kernel1 {kind} n={n}{' shared' if sh else ''} "
                f"({c} launches a prove): "
                f"kernel {t_k:.5f} ms, plain {t_p:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
        log(f"[profile:{tag}] kernel1 {kind}: {len(rows)} launch shapes, kernel == plain held "
            f"at the {held} not held before")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops \
        else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.time()
        prove()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # The rows of kernels and device copies only.  A host operator's row
    # carries the time of the kernels it launched as well: a sum over all rows
    # with device time counts every kernel twice.
    rows = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
    events = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError(f"the profiler saw no device time in the {tag} prove")
    log(f"[profile:{tag}] optdigits warm prove wall {wall * 1e3:.1f} ms, device kernels "
        f"{busy_us / 1e3:.1f} ms busy ({100 * busy_us / 1e6 / wall:.1f}% of wall), "
        f"{sum(e.count for e in events)} device launches")
    if host_ops:
        log(f"[profile:{tag}] summed over the operators' rows too: "
            f"{sum(e.self_device_time_total for e in rows) / 1e3:.1f} ms, "
            f"{sum(e.count for e in rows)} rows' calls")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile:{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    for e in events:  # the hand-written kernels, wherever they rank
        if any(k in e.key for k in OWN_KERNELS):
            log(f"[profile:{tag}]   own kernel {e.self_device_time_total / 1e3:9.3f} ms  "
                f"{e.count:6d}x  {e.key[:70]}")


def phase_profile(rec: dict) -> None:
    """A warm optdigits prove under the recording wrapper and under
    torch.profiler: transparent, zero-knowledge, then in SNARK mode."""
    from otti_tpu_torch import cli, metrics
    from otti_tpu_torch.spartan import hybrid, nizk, snark, spark, zknizk

    with open(os.path.join(REPO, "datasets", "SGD", "pmlb-real-extra.json")) as f:
        params = json.load(f)["optdigits"]
    shape, vars_, inputs, _, _ = cli.lower_sgd("optdigits", params)
    dev = shape.to_device("cuda")
    covered: set = set()
    comm = spark.commit(dev)
    provers = (("plain", lambda: nizk.prove(dev, vars_, inputs)),
               ("zk", lambda: zknizk.prove(dev, vars_, inputs)),
               ("zk-hybrid", lambda: hybrid.prove_zk(dev, vars_, inputs)),
               ("snark", lambda: snark.prove(dev, comm, vars_, inputs)))
    for tag, prove in provers:
        _profile_prove(rec, tag, prove, covered, host_ops=tag in ("plain", "zk"))
        # host wall without the profiler: three warm proves, stage by stage
        for _ in range(3):
            metrics.reset()
            t0 = time.time()
            prove()
            torch.cuda.synchronize()
            log(f"[profile:{tag}] warm prove {1e3 * (time.time() - t0):.1f} ms; prover "
                + json.dumps({k: round(v, 4) for k, v in metrics.snapshot().items()}))


BATCH_LP = (117, 225)
BATCH_SEEDS = tuple(range(1, 9))  # LPs 117 x 225 from these seeds: one class, 2^14 x 2^14
BATCH_SIZES = (1, 4, 8)
BATCH_RUNS = 5  # warm runs of each prover timed in phase batch


def _batch_kernel2(rec: dict, n_cons: int, n_z: int) -> None:
    """Kernel 2 over a batch, one challenge an instance in device memory,
    every round down to the bare final bind == the plain version, at B = 8
    instances of 2^13 rows and at the shapes the batch path gives it:
    phase 1 (cubic) on ``n_cons`` rows and phase 2 (quadratic) on ``n_z``
    rows at each of BATCH_SIZES.  One bind + evaluate round timed at each
    shape against the instances by single launches."""
    from otti_tpu_torch.field.ops import SCALAR, ints_to_limbs
    from otti_tpu_torch.spartan import sumcheck_kernels as SK

    rng = random.Random(8)
    pool = torch.from_numpy(ints_to_limbs([rng.randrange(SCALAR.modulus) for _ in range(4096)])
                            .reshape(4096, 22)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)

    def rand(*shape):  # canonical values over the whole field, drawn on the card
        return pool[torch.randint(0, 4096, shape, generator=gen, device="cuda")]

    shapes = [(8, 1 << 13, 3), (8, 1 << 13, 2)]
    shapes += [(nb, n_cons, 3) for nb in BATCH_SIZES] + [(nb, n_z, 2) for nb in BATCH_SIZES]
    out = {"instances": 8, "n": 1 << 13, "max_abs_err": 0, "shapes": []}
    for nb, n, degree in shapes:
        k = 4 if degree == 3 else 2
        base = [rand(nb, n) for _ in range(k)]
        rs = [rand(nb) for _ in range(n.bit_length() - 1)]
        t_k = [t.clone() for t in base]
        t_p = [t.clone() for t in base]
        ev_k, sn_k = _run_sumcheck(SK.sumcheck_round_cuda, t_k, degree, rs)
        ev_p, sn_p = _run_sumcheck(SK.sumcheck_round_plain, t_p, degree, rs)
        torch.cuda.synchronize()
        tag = f"batched kernel2 deg {degree} B={nb} n={n}"
        if ev_k[-1] is not None or ev_p[-1] is not None:
            raise AssertionError(f"{tag}: the bare final bind evaluated something")
        err = 0
        for rnd, (a, b) in enumerate(zip(ev_k[:-1], ev_p[:-1])):
            if tuple(a.shape) != (nb, 3 if degree == 3 else 2, 22) or not torch.equal(a, b):
                raise AssertionError(f"{tag}: evals differ in round {rnd}")
            err = max(err, int((a - b).abs().max()))
        for rnd, (sa, sb) in enumerate(zip(sn_k, sn_p)):
            for a, b in zip(sa, sb):
                if not torch.equal(a, b):
                    raise AssertionError(f"{tag}: tables differ after round {rnd}")
        del t_k, t_p, sn_k, sn_p
        # one bind + evaluate round at the full size (ah = n / 2)
        tabs = [t.clone() for t in base]
        views = [[t[b] for t in tabs] for b in range(nb)]
        r0 = rs[0]

        def singles():
            for b in range(nb):
                SK.sumcheck_round_cuda(views[b], degree, r0[b], n // 2)

        ms = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, degree, r0, n // 2), 50,
                     queue_ahead=True)
        wrapper = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, degree, r0, n // 2), 50)
        single_ms = cuda_ms(singles, 20, queue_ahead=True)
        plain = cuda_ms(lambda: SK.sumcheck_round_plain(tabs, degree, r0, n // 2), 3)
        b_ms, b_by = round_bound(degree, n, nb)
        row = {"instances": nb, "n": n, "degree": degree, "rounds": len(ev_k) - 1,
               "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
               "singles_ms": single_ms, "bound_ms": b_ms, "bound_by": b_by}
        out["shapes"].append(row)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if (nb, n) == (8, 1 << 13):  # the earlier record's keys
            out["cubic" if degree == 3 else "quad"] = {
                "ms": ms, "wrapper_ms": wrapper, "plain_ms": plain, "single_x8_ms": single_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        log(f"[batch:kernel2] degree {degree}, B={nb} x n={n}, device challenges: "
            f"{row['rounds']} rounds exact down to the bare final bind; one bind+eval round "
            f"{ms:.4f} ms (through the wrapper {wrapper:.4f} ms), the same {nb} instances by "
            f"{nb} single launches {single_ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}")
    rec["kernel2_batched"] = out


def _lower_lps(tmp: str) -> list:
    """The batch instances: LPs of BATCH_LP written from BATCH_SEEDS,
    lowered -> [(path, shape, vars, inputs)], all of one padded class."""
    from otti_tpu_torch.codegen import lp_cert
    from otti_tpu_torch.io import mps
    from otti_tpu_torch.oracle import lp_oracle

    out = []
    for seed in BATCH_SEEDS:
        path = os.path.join(tmp, f"gen{BATCH_LP[0]}x{BATCH_LP[1]}s{seed}.mps")
        write_lp_mps(path, *BATCH_LP, seed=seed)
        prob = mps.parse_mps(path)
        x, y, _ = lp_oracle.solve(prob)
        out.append((path,) + tuple(lp_cert.build(prob, x, y)))
    classes = {(sh.num_cons_padded, sh.num_vars_padded) for _, sh, _, _ in out}
    if len(classes) != 1:
        raise AssertionError(f"the batch LPs fall into {len(classes)} classes: {classes}")
    log(f"[batch] {len(out)} LPs {BATCH_LP[0]} x {BATCH_LP[1]} (seeds {BATCH_SEEDS}): "
        f"{[sh.num_cons for _, sh, _, _ in out]} constraints, one class "
        f"{classes.pop()} (padded constraints x variables)")
    return out


def _batch_cli(rec: dict, lps: list, tmp: str) -> None:
    """The main path of this slice: cli.run_lp(batch=True) on four LPs of one
    class, in zero knowledge (counts set to 0 just before, read just after)
    and transparent; every proof verifies and its meta says batched."""
    from otti_tpu_torch import cli

    paths = [p for p, _, _, _ in lps[:4]]
    for zk, mode, kernels in ((True, "batched-zk", DFS_KERNELS),
                              (False, "batched", ("field_mul", "sumcheck_round", "keccak_f1600"))):
        out_dir = os.path.join(tmp, mode)
        _zero_launches()
        ok, text = _captured(f"batch:{mode}", cli.run_lp, paths, out_dir, zk=zk, batch=True)
        launches = _read_launches(f"batch:{mode}", kernels)
        if zk:
            rec["launches_batch"] = launches
        if not ok or "Batched proving 4 instance(s)" not in text:
            raise AssertionError(f"run_lp(batch=True, zk={zk}) did not prove one batch of 4")
        for p in paths:
            name = os.path.basename(p)
            if f"Verification successful for {name} (batched)" not in text:
                raise AssertionError(f"{name} ({mode}) did not verify")
            meta = _check_meta(f"batch:{mode}", os.path.join(out_dir, "LP", name + ".meta.json"),
                               mode)
            if meta["batch"] != 4:
                raise AssertionError(f"{name}: batch {meta['batch']}, expected 4")


def _warm_runs(fn, runs: int) -> tuple:
    """fn() warm (called once first): (seconds of each of ``runs`` calls,
    kernel launches of one, its stage metrics)."""
    from otti_tpu_torch import _build, metrics

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        before = dict(_build.LAUNCHES)
        metrics.reset()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    stages = {k: round(v, 4) for k, v in metrics.snapshot().items() if k.endswith("_s")}
    return walls, {k: v - before[k] for k, v in _build.LAUNCHES.items()}, stages


def _spread(walls, per=1) -> dict:
    w = sorted(x / per for x in walls)
    return {"median": w[len(w) // 2], "min": w[0], "max": w[-1], "runs": len(w)}


def _show(st) -> str:
    return f"median {st['median']:.4f}s (min {st['min']:.4f}, max {st['max']:.4f})"


def _batch_proofs(rec: dict, lps: list) -> None:
    """prove_many_zk byte-equal to the single-instance hybrid.prove_zk (a
    batch of one, without the batch axis) and to the host-transcript
    zknizk.prove with the same seeds, prove_many to hybrid.prove and
    nizk.prove; no host sync inside the batched chain; then launches, warm
    time and peak memory of a batch at B = 4, 8 against the single default
    (a batch of one) and classic provers."""
    from otti_tpu_torch.spartan import batched, hybrid, nizk, serial, zknizk

    seeds = [bytes([s]) * 32 for s in BATCH_SEEDS]
    devs = [sh.to_device("cuda") for _, sh, _, _ in lps]
    vars_ = [v for _, _, v, _ in lps]
    ins = [i for _, _, _, i in lps]
    many = batched.prove_many_zk(devs[:4], vars_[:4], ins[:4], seeds=seeds[:4])
    for b in range(4):
        got = serial.dumps(many[b])
        if got != serial.dumps(hybrid.prove_zk(devs[b], vars_[b], ins[b], seed=seeds[b])):
            raise AssertionError(f"instance {b}: batched zk proof != hybrid.prove_zk's")
        if got != serial.dumps(zknizk.prove(devs[b], vars_[b], ins[b], seed=seeds[b])):
            raise AssertionError(f"instance {b}: batched zk proof != zknizk.prove's")
        if not zknizk.verify(devs[b], ins[b], many[b]):
            raise AssertionError(f"instance {b}: batched zk proof does not verify")
    if zknizk.verify(devs[1], ins[1], many[0]):
        raise AssertionError("a batched zk proof verified for another instance")
    many = batched.prove_many(devs[:4], vars_[:4], ins[:4])
    for b in range(4):
        got = serial.dumps(many[b])
        if got != serial.dumps(hybrid.prove(devs[b], vars_[b], ins[b])):
            raise AssertionError(f"instance {b}: batched plain proof != hybrid.prove's")
        if got != serial.dumps(nizk.prove(devs[b], vars_[b], ins[b])):
            raise AssertionError(f"instance {b}: batched plain proof != nizk.prove's")
    os.environ["OTTI_SYNC_CHECK"] = "1"
    try:
        batched.prove_many_zk(devs[:4], vars_[:4], ins[:4], seeds=seeds[:4])
        batched.prove_many(devs[:4], vars_[:4], ins[:4])
        torch.cuda.synchronize()
    finally:
        del os.environ["OTTI_SYNC_CHECK"]
    log("[batch] prove_many_zk == hybrid.prove_zk == zknizk.prove (same seeds) and prove_many "
        "== hybrid.prove == nizk.prove on the 4 LPs, byte for byte; every zk proof verifies, "
        "not for another instance; no host sync inside the batched chains (OTTI_SYNC_CHECK)")

    res = {}
    jobs = [("zk-single-default", 1, lambda: hybrid.prove_zk(devs[0], vars_[0], ins[0],
                                                              seed=seeds[0])),
            ("zk-single-classic", 1, lambda: zknizk.prove(devs[0], vars_[0], ins[0],
                                                          seed=seeds[0])),
            ("plain-single-default", 1, lambda: hybrid.prove(devs[0], vars_[0], ins[0])),
            ("plain-single-classic", 1, lambda: nizk.prove(devs[0], vars_[0], ins[0]))]
    for nb in BATCH_SIZES[1:]:  # B = 1 is the single default (hybrid.prove_zk)
        jobs.append((f"zk-batch{nb}", nb, lambda nb=nb: batched.prove_many_zk(
            devs[:nb], vars_[:nb], ins[:nb], seeds=seeds[:nb])))
        jobs.append((f"plain-batch{nb}", nb, lambda nb=nb: batched.prove_many(
            devs[:nb], vars_[:nb], ins[:nb])))
    for tag, nb, fn in jobs:
        walls, per, stages = _warm_runs(fn, BATCH_RUNS)
        mem = _peak_mib(fn)
        res[tag] = {"s": _spread(walls), "s_per_instance": _spread(walls, nb), "launches": per,
                    "stages": stages, "memory": mem}
        log(f"[batch] {tag}{' (B = 1: a batch of one)' if 'default' in tag else ''}: warm "
            f"{'batch' if 'batch' in tag else 'prove'} "
            f"{_show(res[tag]['s'])} over {BATCH_RUNS} runs, {_show(res[tag]['s_per_instance'])} "
            f"an instance; launches {per}; device memory added at the peak "
            f"{mem['peak_mib']:.1f} MiB over {mem['base_mib']:.1f} MiB held before, by stage "
            f"{json.dumps({k: round(v, 1) for k, v in mem['stages_mib'].items()})}; "
            f"stages {json.dumps(stages)}")
    for mode in ("zk", "plain"):  # what each instance adds to the peak, B = 1 -> 8
        lo, hi = res[f"{mode}-single-default"]["memory"], res[f"{mode}-batch8"]["memory"]
        slope = (hi["peak_mib"] - lo["peak_mib"]) / 7
        res[f"{mode}-mib_per_instance"] = slope
        log(f"[batch] {mode}: peak memory {lo['peak_mib']:.1f} MiB at B = 1, "
            f"{hi['peak_mib']:.1f} MiB at B = 8: {slope:.1f} MiB an instance; at B = 8 the "
            f"peak stage is {max(hi['stages_mib'], key=hi['stages_mib'].get, default='-')}")
    rec["batch"] = res
    _batch_profile(rec, {
        "zk-single-default": lambda: hybrid.prove_zk(devs[0], vars_[0], ins[0], seed=seeds[0]),
        "zk-batch8": lambda: batched.prove_many_zk(devs, vars_, ins, seeds=seeds)})


def _peak_mib(fn) -> dict:
    """Device memory that one call of fn() adds at its peak over what was
    allocated before it (MiB), overall and by stage: the witness commit
    (commitments.commit_rows) and the zk chain's stages (hybrid._stage).
    The allocator's counters are kept on the host, so reading them waits
    on nothing."""
    from otti_tpu_torch.spartan import commitments, hybrid

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks, top = {}, [0]

    def fold():
        top[0] = max(top[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    @contextlib.contextmanager
    def stage(name, _device):
        fold()
        try:
            yield
        finally:
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated() - base)
            fold()

    def commit(*a, **kw):
        with stage("commit", None):
            return commit_rows(*a, **kw)

    stage_fn, commit_rows = hybrid._stage, commitments.commit_rows
    hybrid._stage, commitments.commit_rows = stage, commit
    try:
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        fold()
    finally:
        hybrid._stage, commitments.commit_rows = stage_fn, commit_rows
    return {"peak_mib": (top[0] - base) / 2**20, "base_mib": base / 2**20,
            "stages_mib": {k: v / 2**20 for k, v in peaks.items()}}


def _profiled(fn) -> dict:
    """torch.profiler over one call of fn() (warm it first): device
    launches, device time and its share of the wall, and the device time of
    each hand-written kernel.  The device events are read from the
    profiler's raw results: building its per-operator table
    (``key_averages``) takes seconds for every ten thousand events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    busy_ms = sum(e.duration_ns() for e in events) / 1e6
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    own = collections.Counter()
    for e in events:
        for k in OWN_KERNELS:
            if k in e.name():
                own[k] += e.duration_ns() / 1e6
    # the host's launch calls (cudaLaunchKernel, cuLaunchKernel, ...): a replayed
    # graph is one cudaGraphLaunch for all of its kernels
    calls = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.device_type() != DeviceType.CUDA and "Launch" in e.name())
    return {"device_launches": len(events), "device_ms": busy_ms,
            "profiled_wall_ms": wall * 1e3, "busy_share": busy_ms / (wall * 1e3),
            "own_kernels_ms": dict(own), "launch_calls": dict(calls),
            "graph_launches": sum(n for name, n in calls.items() if "Graph" in name)}


def _batch_profile(rec: dict, fns: dict) -> None:
    """torch.profiler over one warm call of each of ``fns`` (the single
    default zk prove, a zk batch of 8): device launches, device time and
    its share of the wall."""
    out = {}
    for tag, fn in fns.items():
        fn()
        out[tag] = _profiled(fn)
        log(f"[batch:profile] {tag}: {out[tag]['device_launches']} device launches, "
            f"{out[tag]['device_ms']:.1f} ms of device time in "
            f"{out[tag]['profiled_wall_ms']:.1f} ms of profiled wall "
            f"({100 * out[tag]['busy_share']:.1f}% busy)")
    rec["batch_profile"] = out


def phase_batch(rec: dict) -> None:
    """Batched proving (spartan/batched.py, the CLI's --batch): kernel 2
    over a batch, then four LPs 117 x 225 of one class through
    cli.run_lp(batch=True), zk and transparent, then byte equality with the
    single-instance provers and the batch's launches, times and memory at
    B = 4 and 8 against the single provers."""
    with tempfile.TemporaryDirectory() as tmp:
        lps = _lower_lps(tmp)
        shape = lps[0][1]
        _batch_kernel2(rec, shape.num_cons_padded, 2 * shape.num_vars_padded)
        _batch_cli(rec, lps, tmp)
        _batch_proofs(rec, lps)


MESH_SHARDS = (2, 4)  # shards on the one card in phase mesh
MESH_RUNS = 5  # warm runs of each prover timed in phase mesh


def _mesh_kernel2(rec: dict, n_cons: int, n_z: int) -> None:
    """Kernel 2's batched entry as the mesh path launches it (the shards of
    one card on the leading axis, one challenge in device memory shared by
    them) == its plain version, every round down to the bare final bind, at
    the path's shard-local shapes: [k, n_cons / k] cubic and [k, n_z / k]
    quadratic for k in MESH_SHARDS.  One bind + evaluate round timed at
    each shape."""
    from otti_tpu_torch.field.ops import SCALAR, ints_to_limbs
    from otti_tpu_torch.spartan import sumcheck_kernels as SK

    rng = random.Random(13)
    pool = torch.from_numpy(ints_to_limbs([rng.randrange(SCALAR.modulus) for _ in range(4096)])
                            .reshape(4096, 22)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(*shape):  # canonical values over the whole field, drawn on the card
        return pool[torch.randint(0, 4096, shape, generator=gen, device="cuda")]

    out = {"max_abs_err": 0, "shapes": []}
    for k in MESH_SHARDS:
        for n, degree in ((n_cons // k, 3), (n_z // k, 2)):
            base = [rand(k, n) for _ in range(4 if degree == 3 else 2)]
            rs = [rand() for _ in range(n.bit_length() - 1)]  # [22]: one for every shard
            t_k = [t.clone() for t in base]
            t_p = [t.clone() for t in base]
            ev_k, sn_k = _run_sumcheck(SK.sumcheck_round_cuda, t_k, degree, rs)
            ev_p, sn_p = _run_sumcheck(SK.sumcheck_round_plain, t_p, degree, rs)
            torch.cuda.synchronize()
            tag = f"mesh kernel2 deg {degree} [{k}, {n}]"
            if ev_k[-1] is not None or ev_p[-1] is not None:
                raise AssertionError(f"{tag}: the bare final bind evaluated something")
            err = 0
            for rnd, (a, b) in enumerate(zip(ev_k[:-1], ev_p[:-1])):
                if tuple(a.shape) != (k, 3 if degree == 3 else 2, 22) or not torch.equal(a, b):
                    raise AssertionError(f"{tag}: evals differ in round {rnd}")
                err = max(err, int((a - b).abs().max()))
            for rnd, (sa, sb) in enumerate(zip(sn_k, sn_p)):
                if not all(torch.equal(a, b) for a, b in zip(sa, sb)):
                    raise AssertionError(f"{tag}: tables differ after round {rnd}")
            del t_k, t_p, sn_k, sn_p
            tabs = [t.clone() for t in base]
            ms = cuda_ms(lambda: SK.sumcheck_round_cuda(tabs, degree, rs[0], n // 2), 50,
                         queue_ahead=True)
            plain = cuda_ms(lambda: SK.sumcheck_round_plain(tabs, degree, rs[0], n // 2), 3)
            b_ms, b_by = round_bound(degree, n, k)
            row = {"shards": k, "n": n, "degree": degree, "rounds": len(ev_k) - 1,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                   "bound_by": b_by}
            out["shapes"].append(row)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"[mesh:kernel2] degree {degree}, [{k}, {n}] with one shared device challenge: "
                f"{row['rounds']} rounds exact down to the bare final bind; one bind+eval round "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    rec["kernel2_mesh"] = out


def _mesh_proofs(rec: dict, insts: dict) -> None:
    """parallel/hybrid_sharded.py with k = 2 and 4 shards on cuda:0: the
    launches of the path (counts set to 0 just before one sharded zk
    prove of the LP 117 x 225, read just after); no host sync in one
    sharded prove; optdigits (zk) and, over MESH_RUNS warm runs each, the
    LP (zk with one seed, and plain) byte-equal to hybrid.prove_zk /
    hybrid.prove (k = 1), verified, a tampered proof rejected; for the LP
    at k = 1, 2 and 4 the warm times, the kernel launches of a warm prove,
    and the device launches of another under torch.profiler, with the
    device memory it adds at its peak."""
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.spartan import hybrid, nizk, serial, zknizk

    seed = bytes(range(32))
    card = torch.device("cuda", 0)
    devs = {name: shape.to_device("cuda") for name, (shape, _, _) in insts.items()}

    def prover(name, zk, k):
        dev, (_, v, i) = devs[name], insts[name]
        if k == 1:
            return ((lambda: hybrid.prove_zk(dev, v, i, seed=seed)) if zk
                    else (lambda: hybrid.prove(dev, v, i)))
        if zk:
            return lambda: HS.prove_zk(dev, v, i, k=k, seed=seed, devices=[card] * k)
        return lambda: HS.prove(dev, v, i, k=k, devices=[card] * k)

    def check(name, zk, proofs):
        """Every proof byte-equal to the first (k = 1), all verified, a
        tampered one rejected."""
        dev, inputs = devs[name], insts[name][2]
        verify = zknizk.verify if zk else nizk.verify
        want = serial.dumps(proofs[0][1])
        for k, proof in proofs:
            if serial.dumps(proof) != want:
                raise AssertionError(f"{name}: the {k}-shard {'zk' if zk else 'plain'} proof "
                                     "differs from the single-device one")
        for k, proof in {k: p for k, p in proofs}.items():
            if not verify(dev, inputs, proof):
                raise AssertionError(f"{name}: the {k}-shard proof does not verify")
        bad = dataclasses.replace(proof, bullet=dataclasses.replace(
            proof.bullet, z1=(proof.bullet.z1 + 1) % zknizk.L))
        if verify(dev, inputs, bad):
            raise AssertionError(f"{name}: a sharded proof with a tampered bullet.z1 verified")
        log(f"[mesh] {name} {'zk (one seed)' if zk else 'plain'}: {len(proofs)} proofs over "
            f"1, {' and '.join(map(str, MESH_SHARDS))} shards on {card}, byte for byte the "
            "single-device prover's; verified; a tampered bullet.z1 rejected")

    # the main path of this slice
    t0 = time.time()
    _zero_launches()
    prover("lp117x225", True, 2)()
    torch.cuda.synchronize()
    rec["launches_mesh"] = _read_launches("mesh:lp117x225:zk:k=2", ZK_KERNELS)
    os.environ["OTTI_SYNC_CHECK"] = "1"
    try:
        prover("lp117x225", True, 2)()
        torch.cuda.synchronize()
    finally:
        del os.environ["OTTI_SYNC_CHECK"]
    log("[mesh] no host sync between the two transfers of a 2-shard zk prove "
        f"(OTTI_SYNC_CHECK); the main path and the check {time.time() - t0:.1f}s")
    t0 = time.time()
    check("optdigits", True, [(k, prover("optdigits", True, k)()) for k in (1,) + MESH_SHARDS])
    log(f"[mesh] optdigits {time.time() - t0:.1f}s")

    res = {}
    for zk in (True, False):
        t0 = time.time()
        proofs = []
        for k in (1,) + MESH_SHARDS:
            tag = f"{'zk' if zk else 'plain'}-k{k}"
            fn = prover("lp117x225", zk, k)

            def run(fn=fn, k=k):
                proofs.append((k, fn()))

            walls, per, stages = _warm_runs(run, MESH_RUNS)
            mem = {}  # one more prove, profiled, and its memory read (host counters)
            prof = _profiled(lambda fn=fn: mem.update(_peak_mib(fn)))
            res[tag] = {"s": _spread(walls), "launches": per, "stages": stages, "memory": mem,
                        "profile": prof}
            rec.setdefault("launches_per_prove", {})[f"{tag}-mesh:lp117x225"] = per
            log(f"[mesh] LP 117 x 225 {tag}{' (hybrid, one device)' if k == 1 else ''}: warm "
                f"prove {_show(res[tag]['s'])} over {MESH_RUNS} runs; launches {per}; "
                f"{prof['device_launches']} device launches, {prof['device_ms']:.1f} ms of "
                f"device time in {prof['profiled_wall_ms']:.1f} ms "
                f"({100 * prof['busy_share']:.1f}% busy); device memory added at the peak "
                f"{mem['peak_mib']:.1f} MiB over {mem['base_mib']:.1f} MiB held before, by "
                f"stage {json.dumps({k_: round(v, 1) for k_, v in mem['stages_mib'].items()})}; "
                f"stages {json.dumps(stages)}")
        check("lp117x225", zk, proofs)
        log(f"[mesh] LP 117 x 225 {'zk' if zk else 'plain'} {time.time() - t0:.1f}s")
    rec["mesh"] = res


def _mesh_cards(rec: dict, insts: dict) -> None:
    """With two cards or more: the LP 117 x 225 (zk with one seed, and
    plain) with its shards on distinct cards, byte-equal to hybrid's proof
    on cuda:0, and the warm times over MESH_RUNS runs (2 shards on cuda:0
    and cuda:1; 4 shards on four cards, or two a card on two); no host
    sync in a zk prove over two cards."""
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.spartan import hybrid, serial

    cards = torch.cuda.device_count()
    if cards < 2:
        log("[mesh:cards] one card visible: shards on distinct cards not run")
        return
    seed = bytes(range(32))
    shape, v, i = insts["lp117x225"]
    dev = shape.to_device("cuda:0")
    want = {True: serial.dumps(hybrid.prove_zk(dev, v, i, seed=seed)),
            False: serial.dumps(hybrid.prove(dev, v, i))}
    res = {}
    for ids in ([0, 1], [0, 1, 2, 3] if cards >= 4 else [0, 1, 0, 1]):
        devices = [torch.device("cuda", c) for c in ids]
        k = len(ids)
        for zk in (True, False):
            fn = ((lambda: HS.prove_zk(dev, v, i, k=k, seed=seed, devices=devices)) if zk
                  else (lambda: HS.prove(dev, v, i, k=k, devices=devices)))
            got = []
            walls, per, stages = _warm_runs(lambda: got.append(serial.dumps(fn())), MESH_RUNS)
            torch.cuda.synchronize()
            if any(g != want[zk] for g in got):
                raise AssertionError(f"{k} shards on cards {ids}: a {'zk' if zk else 'plain'} "
                                     "proof differs from hybrid's on cuda:0")
            tag = f"{'zk' if zk else 'plain'}-k{k}-cards{''.join(map(str, ids))}"
            res[tag] = {"s": _spread(walls), "launches": per, "stages": stages}
            log(f"[mesh:cards] LP 117 x 225 {tag}: {len(got)} proofs byte-equal to hybrid's on "
                f"cuda:0; warm prove {_show(res[tag]['s'])} over {MESH_RUNS} runs; launches "
                f"{per}; stages {json.dumps(stages)}")
    rec["mesh_cards"] = res
    os.environ["OTTI_SYNC_CHECK"] = "1"
    try:
        HS.prove_zk(dev, v, i, k=2, seed=seed, devices=[torch.device("cuda", c) for c in (0, 1)])
        torch.cuda.synchronize()
    finally:
        del os.environ["OTTI_SYNC_CHECK"]
    log("[mesh:cards] no host sync between the two transfers of a zk prove over cuda:0 and "
        "cuda:1 (OTTI_SYNC_CHECK)")


def _mesh_cli(rec: dict, tmp: str) -> None:
    """cli.run_lp with --mesh auto: k = 1 on one card (the single-device
    prover, meta mode zk), else the largest power of two of the cards (at
    least 2 shards, each on a card of its own)."""
    from otti_tpu_torch import cli

    lp = os.path.join(tmp, "gen117x225.mps")
    cards = torch.cuda.device_count()
    k = 1 << (cards.bit_length() - 1)
    mode = "zk" if k == 1 else f"zk-mesh{k}"
    ok, _ = _captured("mesh:cli", cli.run_lp, [lp], os.path.join(tmp, "mesh"), zk=True,
                      mesh="auto")
    if not ok:
        raise AssertionError("run_lp(mesh='auto') did not verify")
    _check_meta("mesh:cli", os.path.join(tmp, "mesh", "LP", "gen117x225.mps.meta.json"), mode)
    log(f"[mesh:cli] run_lp(mesh='auto') with {cards} card(s) visible: meta mode {mode!r}"
        + (" (resolved to k = 1: the single-device prover)" if k == 1 else ""))


def phase_mesh(rec: dict) -> None:
    """Sharded proving (parallel/hybrid_sharded.py, the CLI's --mesh) with 2
    and 4 shards on cuda:0: kernel 2 at the path's shard shapes, the
    proofs against the single-device ones, the numbers of k = 1, 2, 4;
    with two cards or more, shards on distinct cards; the CLI's --mesh."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        insts = _dfs_instances(tmp, ("optdigits", "lp117x225"))
        log(f"[mesh] optdigits and the LP 117 x 225 lowered in {time.time() - t0:.1f}s")
        shape = insts["lp117x225"][0]
        t0 = time.time()
        _mesh_kernel2(rec, shape.num_cons_padded, 2 * shape.num_vars_padded)
        log(f"[mesh] kernel 2 checked and timed in {time.time() - t0:.1f}s")
        _mesh_proofs(rec, insts)
        t0 = time.time()
        _mesh_cards(rec, insts)
        log(f"[mesh] shards on distinct cards in {time.time() - t0:.1f}s")
        t0 = time.time()
        _mesh_cli(rec, tmp)
        log(f"[mesh] the CLI in {time.time() - t0:.1f}s")


DIST_RUNS = 5  # warm runs of the sharded zk prove timed in phase dist
DIST_TIMEOUT = 300  # seconds a rank of phase dist may take
DIST_SEED = bytes(range(32))
MSM_SIZES = (96, 1 << 10, 1 << 16)  # the var-base MSM on the card in phase dist


def _lower_lp(path: str) -> tuple:
    from otti_tpu_torch.codegen import lp_cert
    from otti_tpu_torch.io import mps
    from otti_tpu_torch.oracle import lp_oracle

    prob = mps.parse_mps(path)
    x, y, _ = lp_oracle.solve(prob)
    return lp_cert.build(prob, x, y)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tag: str, argvs: list, env: dict, labels=None) -> list:
    """One subprocess a rank (``labels``: their names, rank0, rank1, ... by
    default), all started together; -> [(stdout, stderr)].
    Any rank that fails, outlives DIST_TIMEOUT or leaves no output fails
    the phase; every process is ended before this returns."""
    labels = labels or [f"rank{r}" for r in range(len(argvs))]
    procs = [subprocess.Popen(a, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in argvs]
    outs, deadline = [], time.time() + DIST_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[{tag}] {labels[r]} ran past {DIST_TIMEOUT}s"
                                     + _rank_tails(procs[r:], labels[r:])) from None
            for line in out.splitlines():
                log(f"[{tag}:{labels[r]}] {line}")
            if p.returncode != 0 or not out.strip():
                raise AssertionError(f"[{tag}] {labels[r]} exited {p.returncode}:\n{err[-3000:]}")
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _rank_tails(procs: list, labels: list) -> str:
    """What the ranks still running wrote to stderr, each stopped by SIGABRT
    first (their environment enables faulthandler, which then prints every
    thread's Python stack)."""
    text = ""
    for p, label in zip(procs, labels):
        if p.poll() is None:
            p.send_signal(signal.SIGABRT)
        try:
            _, err = p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        text += f"\n--- {label} (rc {p.returncode}), stderr:\n{(err or '')[-3000:]}"
    return text


def _rank_env(world: int, one_card: bool) -> dict:
    """The ranks' environment: with ``one_card`` every rank sees only the
    first visible card (ranks share it: gloo); else each its own (NCCL)."""
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONFAULTHANDLER="1")
    if one_card:
        env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return env


def _dist_cli(rec: dict, tmp: str, lp: str, world: int, backend: str, plain_ref: str,
              mono: bool = False) -> None:
    """python -m otti_tpu_torch.cli --lp --custom LP --mesh W as W ranks
    (transparent and zk side by side, a rendezvous each): every rank exits
    0 and verifies, rank 0 alone writes --out, its meta names the backend,
    and its transparent proof is hybrid.prove's in one process.  With
    ``mono`` under OTTI_MESH_MONOLITHIC=1 (parallel/fused_prover.py), whose
    meta says graph true under NCCL (a rank's core captured) and false
    under gloo."""
    from otti_tpu_torch.spartan import serial

    tag = f"dist:cli:{backend}:W={world}" + (":mono" if mono else "")
    graph = mono and backend == "nccl"
    argvs, outs, labels = [], {}, []
    for zk in (False, True):
        port, mode = _free_port(), "zk" if zk else "plain"
        outs[mode] = [os.path.join(tmp, f"{tag.replace(':', '_')}_{mode}_{r}") for r in range(world)]
        argvs += [[sys.executable, "-m", "otti_tpu_torch.cli", "--lp", "--custom", lp, "--mesh",
                   str(world), "--coordinator", f"127.0.0.1:{port}", "--num-hosts", str(world),
                   "--host-id", str(r), "--out", outs[mode][r]] + ([] if zk else ["--transparent"])
                  for r in range(world)]
        labels += [f"{mode}:rank{r}" for r in range(world)]
    t0 = time.time()
    env = _rank_env(world, backend == "gloo")
    if mono:
        env["OTTI_MESH_MONOLITHIC"] = "1"
    res = _run_ranks(tag, argvs, env, labels)
    for (out, _), argv in zip(res, argvs):
        if "Verification successful for gen117x225.mps" not in out:
            raise AssertionError(f"[{tag}] a rank did not verify: {' '.join(argv[3:])}")
    for mode, dirs in outs.items():
        if any(os.path.exists(d) for d in dirs[1:]):
            raise AssertionError(f"[{tag}] a rank other than 0 wrote --out")
        meta = os.path.join(dirs[0], "LP", "gen117x225.mps.meta.json")
        with open(meta) as f:
            m = json.load(f)
        if (m["mode"], m["dist_backend"], m["world_size"], m["card"], m["verified"],
                m["graph"]) != (f"{mode}-mesh{world}", backend, world, "cuda:0", True, graph):
            raise AssertionError(f"[{tag}] {meta}: {m}")
        log(f"[{tag}] rank 0's meta: mode {m['mode']}, graph {m['graph']}, backend "
            f"{m['dist_backend']}, card "
            f"{m['card']} ({m['device']}), prove {m['timings']['prove']:.4f}s (cold), verify "
            f"{m['timings']['verify']:.4f}s")
    with open(os.path.join(outs["plain"][0], "LP", "gen117x225.mps.proof.json")) as f:
        if serial.dumps(serial.loads(f.read())) != plain_ref:
            raise AssertionError(f"[{tag}] rank 0's transparent proof is not hybrid.prove's")
    log(f"[{tag}] {world} ranks of the CLI, transparent and zk: all verified, rank 0 alone "
        f"wrote --out, its transparent proof byte-equal to hybrid.prove in one process; "
        f"{time.time() - t0:.1f}s")


def _dist_workers(tmp: str, lp: str, world: int, backend: str) -> list:
    """This script's --dist-worker as W ranks (_dist_worker); their records."""
    tag = f"dist:{backend}:W={world}"
    port, t0 = _free_port(), time.time()
    outs = [os.path.join(tmp, f"worker_{backend}_{world}_{r}.json") for r in range(world)]
    _run_ranks(tag, [[sys.executable, os.path.abspath(__file__), "--dist-worker",
                      f"{r},{world},{port},{lp},{outs[r]}"] for r in range(world)],
               _rank_env(world, backend == "gloo"))
    res = []
    for r, path in enumerate(outs):
        with open(path) as f:
            res.append(json.load(f))
        if res[-1]["backend"] != backend:
            raise AssertionError(f"[{tag}] rank {r} joined under {res[-1]['backend']}")
    log(f"[{tag}] {world} worker ranks in {time.time() - t0:.1f}s")
    return res


def _dist_worker(spec: str) -> int:
    """One rank of phase dist: the LP 117 x 225 in zero knowledge over W
    ranks (one seed) byte-equal to hybrid.prove_zk on this rank, every
    kernel of the path launched (the counts set to 0 just before, read just
    after), a tampered proof rejected, no host sync under NCCL
    (OTTI_SYNC_CHECK); sharded.py's four functions at the LP's 2^14 rows
    against one shard; DIST_RUNS warm proves, their launches and a profiled
    one.  Writes its record (JSON) to the path in ``spec``."""
    import torch.distributed as dist

    from otti_tpu_torch import metrics, native, runtime
    from otti_tpu_torch.curve import edwards as E
    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.field.fields import BASE, SCALAR
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.parallel import sharded as SH
    from otti_tpu_torch.msm import pippenger
    from otti_tpu_torch.refimpl import numeric as ref
    from otti_tpu_torch.spartan import hybrid, r1cs, serial, zknizk

    rank, world, port, lp, out = spec.split(",")
    rank, world = int(rank), int(world)
    runtime.init_distributed(f"127.0.0.1:{port}", world, rank, "cuda")
    group, card = dist.group.WORLD, torch.device("cuda", torch.cuda.current_device())
    tag = f"dist:rank{rank}"
    rec = {"rank": rank, "backend": dist.get_backend(), "card": str(card),
           "card_name": torch.cuda.get_device_name(card)}
    shape, v, i = _lower_lp(lp)
    dev = shape.to_device(card)

    def prove():
        return HS.prove_zk(dev, v, i, k=world, seed=DIST_SEED, group=group)

    _zero_launches()
    proof = prove()  # the main path of this slice
    torch.cuda.synchronize()
    rec["launches_main"] = _read_launches(tag)
    if serial.dumps(proof) != serial.dumps(hybrid.prove_zk(dev, v, i, seed=DIST_SEED)):
        raise AssertionError(f"[{tag}] the {world}-rank zk proof is not hybrid.prove_zk's")
    if not zknizk.verify(dev, i, proof):
        raise AssertionError(f"[{tag}] the {world}-rank zk proof does not verify")
    bad = dataclasses.replace(proof, bullet=dataclasses.replace(
        proof.bullet, z1=(proof.bullet.z1 + 1) % zknizk.L))
    if zknizk.verify(dev, i, bad):
        raise AssertionError(f"[{tag}] a tampered bullet.z1 verified")
    log(f"[{tag}] zk over {world} ranks ({rec['backend']}, {card}) byte-equal to hybrid.prove_zk; "
        "verified; a tampered bullet.z1 rejected")
    if rec["backend"] == "nccl":
        os.environ["OTTI_SYNC_CHECK"] = "1"
        try:
            prove()
            torch.cuda.synchronize()
        finally:
            del os.environ["OTTI_SYNC_CHECK"]
        log(f"[{tag}] no host sync between the two transfers under NCCL (OTTI_SYNC_CHECK)")

    # sharded.py at the LP's padded rows, against one shard on this card
    n = shape.num_cons_padded
    mesh, one = SH.make_mesh(device=card, group=group), SH.Mesh((card,))
    _, rand = _field_pool(29)
    tabs = [rand(n) for _ in range(4)]
    r = rand()
    checks = {}

    def same(name, a, b):
        if not torch.equal(F.canon(SCALAR, a), F.canon(SCALAR, b)):
            raise AssertionError(f"[{tag}] sharded.{name} differs from one shard")
        checks[name] = list(a.shape)

    sh_t = [SH.shard(mesh, t) for t in tabs]
    same("round_cubic_sharded", torch.stack(SH.round_cubic_sharded(mesh, *sh_t)),
         torch.stack(SH.round_cubic_sharded(one, *([t] for t in tabs))))
    (b_sh,), (b_one,) = SH.bind_sharded(mesh, r, sh_t[0]), SH.bind_sharded(one, r, [tabs[0]])
    same("bind_sharded", SH.unshard(mesh, b_sh), b_one[0])
    rows, cols, vals = dev.mats[0]
    pad = (-rows.shape[0]) % world  # value-0 entries at (0, 0)
    rows, cols = (torch.cat([x, x.new_zeros(pad)]) for x in (rows, cols))
    vals = torch.cat([vals, vals.new_zeros((pad, 22))])
    z = r1cs.assemble_z(F.from_ints(SCALAR, list(v) + [0] * (dev.num_vars - len(v)), card),
                        F.from_ints(SCALAR, list(i), card) if i else None, dev.num_vars)
    mv = SH.matvec_sharded(mesh, SH.shard(mesh, rows), SH.shard(mesh, cols),
                           SH.shard(mesh, vals), z, dev.num_cons)
    same("matvec_sharded", mv, SH.matvec_sharded(one, [rows], [cols], [vals], z, dev.num_cons))
    same("matvec_sharded vs R1CSDevice.matvecs", mv, dev.matvecs(z)[0])
    rng = random.Random(31)
    pts = [native.scalar_mul_host(ref.EdPoint.base(), rng.randrange(1, ref.L)) for _ in range(n)]
    pts_d = E.pt(*(F.from_ints(BASE, [getattr(p, c) for p in pts], card) for c in "XYZT"))
    sc = F.from_ints(SCALAR, [rng.randrange(ref.L) for _ in range(n)], card)
    blocks = [dict(zip(E.COORDS, q)) for q in zip(*(SH.shard(mesh, pts_d[c]) for c in E.COORDS))]
    got = E.to_ref(SH.msm_sharded(mesh, blocks, SH.shard(mesh, sc)))
    if got != E.to_ref(pippenger.msm(pts_d, sc, window=4)):
        raise AssertionError(f"[{tag}] sharded.msm_sharded differs from one shard")
    checks["msm_sharded"] = [n]
    rec["sharded"] = checks
    log(f"[{tag}] sharded.py over {world} ranks == one shard at {n} rows: {json.dumps(checks)}")

    walls, per, stages = _warm_runs(prove, DIST_RUNS)
    rec.update(warm=_spread(walls), launches_warm=per, stages=stages, profile=_profiled(prove))
    metrics.reset()
    log(f"[{tag}] LP 117 x 225 zk over {world} ranks: warm {_show(rec['warm'])}; launches {per}; "
        f"{rec['profile']['device_launches']} device launches, "
        f"{rec['profile']['device_ms']:.1f} ms device time")
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def _dist_msm(rec: dict) -> None:
    """The var-base MSM (msm/pippenger.py::msm) on the card == the host
    library's Pippenger at MSM_SIZES, with its time, kernel-1 launches and
    the device memory it adds at its peak."""
    from otti_tpu_torch import _build, native
    from otti_tpu_torch.curve import edwards as E
    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.field.fields import BASE, SCALAR
    from otti_tpu_torch.msm import pippenger
    from otti_tpu_torch.refimpl import numeric as ref

    rng = random.Random(37)
    out = []
    for n in MSM_SIZES:
        pts = [native.scalar_mul_host(ref.EdPoint.base(), rng.randrange(1, ref.L))
               for _ in range(n)]
        ks = [rng.randrange(ref.L) for _ in range(n)]
        pts_d = E.pt(*(F.from_ints(BASE, [getattr(p, c) for p in pts], "cuda") for c in "XYZT"))
        sc = F.from_ints(SCALAR, ks, "cuda")
        pippenger.msm(pts_d, sc)  # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        got = pippenger.msm(pts_d, sc)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        k1 = _build.LAUNCHES["field_mul"]
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        t0 = time.perf_counter()
        want = native.msm_host(pts, ks)
        host_ms = (time.perf_counter() - t0) * 1e3
        if E.to_ref(got) != want:
            raise AssertionError(f"[dist:msm] n = {n}: the card's msm differs from msm_host")
        row = {"n": n, "window": pippenger.pick_window(n), "ms": ms, "k1_launches": k1,
               "peak_mib": peak, "host_ms": host_ms}
        out.append(row)
        log(f"[dist:msm] n = {n} (window {row['window']}): == native.msm_host; warm "
            f"{ms:.1f} ms on the card ({host_ms:.1f} ms for the host library), {k1} K1 launches, "
            f"{peak:.1f} MiB added at the peak")
    rec["msm"] = out


def phase_dist(rec: dict) -> None:
    """Proving across processes (runtime.init_distributed, the CLI's
    --coordinator/--num-hosts/--host-id): the var-base MSM on the card;
    two ranks on the one card under gloo, by the CLI and by this script's
    worker; the warm times against one process; with two cards or more
    the same under NCCL, a card a rank, at W = 2 and 4."""
    from otti_tpu_torch import _build
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.spartan import hybrid, serial

    _build.library()  # built once here; the ranks load it
    _dist_msm(rec)
    with tempfile.TemporaryDirectory() as tmp:
        lp = os.path.join(tmp, "gen117x225.mps")
        write_lp_mps(lp, 117, 225, seed=1)
        shape, v, i = _lower_lp(lp)
        dev = shape.to_device("cuda")
        plain_ref = serial.dumps(hybrid.prove(dev, v, i))
        _dist_cli(rec, tmp, lp, 2, "gloo", plain_ref)
        ranks = _dist_workers(tmp, lp, 2, "gloo")
        rec["launches_dist"] = ranks[0]["launches_main"]
        single = {}
        for k in (1, 2):
            fn = ((lambda: hybrid.prove_zk(dev, v, i, seed=DIST_SEED)) if k == 1 else
                  (lambda: HS.prove_zk(dev, v, i, k=2, seed=DIST_SEED,
                                       devices=[torch.device("cuda", 0)] * 2)))
            walls, per, _ = _warm_runs(fn, DIST_RUNS)
            single[k] = {"s": _spread(walls), "launches": per}
        rec["dist"] = {"gloo_W2": ranks, "one_process": single}
        log(f"[dist] LP 117 x 225 zk, warm medians of {DIST_RUNS}: 2 ranks on one card (gloo) "
            + ", ".join(f"rank {r['rank']} {r['warm']['median']:.4f}s" for r in ranks)
            + f"; one process --mesh k=2 {single[2]['s']['median']:.4f}s, k=1 "
            f"{single[1]['s']['median']:.4f}s; kernel launches a prove "
            + "; ".join(f"rank {r['rank']} {r['launches_warm']}" for r in ranks)
            + f"; one process k=2 {single[2]['launches']}, k=1 {single[1]['launches']}; device "
            "launches " + ", ".join(f"rank {r['rank']} {r['profile']['device_launches']}"
                                    for r in ranks))
        cards = torch.cuda.device_count()
        if cards < 2:
            log("[dist] one card visible: NCCL (a card a rank) not run")
            return
        for world in (2, 4) if cards >= 4 else (2,):
            _dist_cli(rec, tmp, lp, world, "nccl", plain_ref)
            ranks = _dist_workers(tmp, lp, world, "nccl")
            rec["dist"][f"nccl_W{world}"] = ranks
            log(f"[dist] LP 117 x 225 zk over {world} cards (NCCL), warm medians of {DIST_RUNS}: "
                + ", ".join(f"rank {r['rank']} {r['warm']['median']:.4f}s" for r in ranks)
                + "; kernel launches a prove " + "; ".join(
                    f"rank {r['rank']} {r['launches_warm']}" for r in ranks)
                + "; device launches " + ", ".join(
                    f"rank {r['rank']} {r['profile']['device_launches']}" for r in ranks))


MONO_SHARDS = (1, 2, 4)  # shards on the one card in phase mono
MONO_RUNS = 5  # warm replays timed a prover in phase mono
MONO_EAGER_RUNS = 3  # warm runs of each eager prover timed beside them
MONO_SEEDS = (bytes(range(32)), bytes(range(1, 33)))  # blind seeds of the two LPs


MONO_STAGES = ("commit", "matvecs", "zk_phase1", "zk_mid", "m_table", "zk_phase2", "eval_at",
               "opening")  # the captured zk chain's hybrid._stage names


def _check_stage_times(tag: str, stages: dict, zk: bool) -> None:
    """The event counters of one replay (_warm_runs' last): the graph's
    device time, and in zk every stage's, whose sum lies within 5 % of it;
    logged in ms."""
    want = ("graph_device_s",) + tuple(n + "_dev_s" for n in MONO_STAGES if zk)
    missing = [k for k in want if k not in stages]
    if missing:
        raise AssertionError(f"[mono] {tag}: no event counters {missing}")
    graph = stages["graph_device_s"]
    summed = sum(v for k, v in stages.items() if k.endswith("_dev_s"))
    if zk and not 0.95 * graph <= summed <= 1.05 * graph:
        raise AssertionError(f"[mono] {tag}: the stages sum to {summed:.4f}s of the graph's "
                             f"{graph:.4f}s")
    log(f"[mono] {tag}: a replay's device time {1e3 * graph:.1f} ms, by stage (ms) "
        + json.dumps({k[:-6]: round(1e3 * v, 1) for k, v in stages.items()
                      if k.endswith("_dev_s")}))


def _mono_eager(fn):
    """fn() with parallel/fused_prover.py's core uncaptured (its captures
    answering no) under OTTI_SYNC_CHECK=1: the eager core, which must not
    wait on the card before its fetch."""
    from otti_tpu_torch.parallel import fused_prover as FP

    captures = FP.captures
    FP.captures = lambda devices, group=None: False
    os.environ["OTTI_SYNC_CHECK"] = "1"
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        FP.captures = captures
        del os.environ["OTTI_SYNC_CHECK"]


def _mono_lps(tmp: str, card) -> list:
    """The LP 117 x 225 of seeds 1 and 2 (write_lp_mps), lowered and on
    ``card``: two instances of one padded class."""
    insts = []
    for seed in (1, 2):
        path = os.path.join(tmp, f"gen117x225_{seed}.mps")
        write_lp_mps(path, 117, 225, seed=seed)
        shape, v, i = _lower_lp(path)
        insts.append((shape.to_device(card), v, i))
    classes = {(d.num_cons, d.num_vars) for d, _, _ in insts}
    if len(classes) != 1:
        raise AssertionError(f"the two LPs are not of one padded class: {classes}")
    return insts


def _mono_lp(rec: dict, insts: list, card) -> None:
    """parallel/fused_prover.py on the two LPs at k = MONO_SHARDS shards on
    ``card``, zk (a blind seed an LP) and plain: the launches of the path
    (the counts set to 0 just before the cold zk prove at k = 2, read just
    after); each cold prove (the eager warm-up, the capture and its
    instantiation, the replay) byte-equal to hybrid's and verified, a
    tampered zk proof rejected; LP 2 replayed through LP 1's graph, byte-
    equal to hybrid's and to the eager core's (no host sync in it); then
    MONO_RUNS warm replays, one under torch.profiler (graph launches,
    device launches, busy share), each graph's cost and pool, beside
    MONO_EAGER_RUNS warm runs of hybrid (k = 1) and hybrid_sharded."""
    from otti_tpu_torch.parallel import fused_prover as FP
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.spartan import hybrid, nizk, serial, zknizk

    t0 = time.time()
    refs = {}
    for n, (d, v, i) in enumerate(insts):
        refs[n, True] = serial.dumps(hybrid.prove_zk(d, v, i, seed=MONO_SEEDS[n]))
        refs[n, False] = serial.dumps(hybrid.prove(d, v, i))
    log(f"[mono] hybrid's proofs of the two LPs (the references) in {time.time() - t0:.1f}s")

    def mono(n, zk, k):
        d, v, i = insts[n]
        if zk:
            return lambda: FP.prove_zk(d, v, i, k=k, seed=MONO_SEEDS[n], devices=[card] * k)
        return lambda: FP.prove(d, v, i, k=k, devices=[card] * k)

    def eager(zk, k):
        d, v, i = insts[0]
        if k == 1:
            return ((lambda: hybrid.prove_zk(d, v, i, seed=MONO_SEEDS[0])) if zk
                    else (lambda: hybrid.prove(d, v, i)))
        if zk:
            return lambda: HS.prove_zk(d, v, i, k=k, seed=MONO_SEEDS[0], devices=[card] * k)
        return lambda: HS.prove(d, v, i, k=k, devices=[card] * k)

    res = {}
    for zk in (True, False):
        mode = "zk" if zk else "plain"
        verify = zknizk.verify if zk else nizk.verify
        for k in (2, 1, 4):  # k = 2 first: the main path of this slice
            tag = f"{mode}-k{k}"
            t0 = time.time()
            if (zk, k) == (True, 2):
                _zero_launches()
            start = time.perf_counter()
            proof = mono(0, zk, k)()
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - start
            if (zk, k) == (True, 2):
                rec["launches_mono"] = _read_launches("mono:lp117x225:zk:k=2", ZK_KERNELS)
            if serial.dumps(proof) != refs[0, zk]:
                raise AssertionError(f"[mono] {tag}: the captured proof is not hybrid's")
            d, _, i = insts[0]
            if not verify(d, i, proof):
                raise AssertionError(f"[mono] {tag}: the proof does not verify")
            if zk and k == 2:
                bad = dataclasses.replace(proof, bullet=dataclasses.replace(
                    proof.bullet, z1=(proof.bullet.z1 + 1) % zknizk.L))
                if verify(d, i, bad):
                    raise AssertionError("[mono] a tampered bullet.z1 verified")
            graphs = len(FP.graphs())
            second = serial.dumps(mono(1, zk, k)())
            if len(FP.graphs()) != graphs:
                raise AssertionError(f"[mono] {tag}: LP 2 took a graph of its own, not LP 1's")
            if second != refs[1, zk]:
                raise AssertionError(f"[mono] {tag}: LP 2's replayed proof is not hybrid's")
            if serial.dumps(_mono_eager(mono(1, zk, k))) != second:
                raise AssertionError(f"[mono] {tag}: LP 2's replay differs from the eager core")
            walls, _, stages = _warm_runs(mono(0, zk, k), MONO_RUNS)
            _check_stage_times(tag, stages, zk)
            prof = _profiled(mono(0, zk, k))
            if prof["graph_launches"] < 1:
                raise AssertionError(f"[mono] {tag}: the profiler saw no graph launch")
            g = [x for x in FP.graphs() if (x["zk"], x["k"]) == (zk, k)][-1]
            e_walls, e_per, _ = _warm_runs(eager(zk, k), MONO_EAGER_RUNS)
            e_prof = _profiled(eager(zk, k))
            res[tag] = {"cold_s": cold_s, "graph": g, "s": _spread(walls), "stages": stages,
                        "profile": prof, "eager": {"s": _spread(e_walls), "launches": e_per,
                                                   "profile": e_prof}}
            log(f"[mono] LP 117 x 225 {tag}: cold prove {cold_s:.4f}s (eager warm-up "
                f"{g['warmup_s']:.4f}s, capture and instantiation {g['capture_s']:.4f}s, pool "
                f"{g['pool_mib']:.1f} MiB, launches captured {g['launches']}); byte-equal to "
                f"hybrid's, verified{', a tampered proof rejected' if zk and k == 2 else ''}; LP 2 "
                f"through the same graph byte-equal to hybrid's and to the eager core (no host "
                f"sync); warm replay {_show(res[tag]['s'])} over {MONO_RUNS} runs; profiled: "
                f"{prof['graph_launches']} graph launch(es), launch calls "
                f"{json.dumps(prof['launch_calls'])}, {prof['device_launches']} device launches, "
                f"{prof['device_ms']:.1f} ms device time in {prof['profiled_wall_ms']:.1f} ms "
                f"({100 * prof['busy_share']:.1f}% busy); beside it "
                f"{'hybrid' if k == 1 else 'hybrid_sharded'} warm {_show(res[tag]['eager']['s'])} "
                f"over {MONO_EAGER_RUNS} runs, {e_prof['device_launches']} device launches, "
                f"{100 * e_prof['busy_share']:.1f}% busy; {time.time() - t0:.1f}s")
    rec["mono"] = res


def _mono_optdigits(rec: dict, tmp: str, card) -> None:
    """optdigits 3v8 in zero knowledge over 2 shards on ``card``, captured
    (cold, then a replay), byte-equal to hybrid.prove_zk with one seed."""
    from otti_tpu_torch.parallel import fused_prover as FP
    from otti_tpu_torch.spartan import hybrid, serial, zknizk

    shape, v, i = _dfs_instances(tmp, ("optdigits",))["optdigits"]
    d = shape.to_device(card)
    want = serial.dumps(hybrid.prove_zk(d, v, i, seed=MONO_SEEDS[0]))
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        proof = FP.prove_zk(d, v, i, k=2, seed=MONO_SEEDS[0], devices=[card] * 2)
        walls.append(time.perf_counter() - t0)
        if serial.dumps(proof) != want:
            raise AssertionError("[mono] optdigits: the captured zk proof is not hybrid's")
    if not zknizk.verify(d, i, proof):
        raise AssertionError("[mono] optdigits: the zk proof does not verify")
    g = FP.graphs()[-1]
    rec["mono_optdigits"] = {"cold_s": walls[0], "warm_s": walls[1], "graph": g}
    log(f"[mono] optdigits zk k=2 ({d.num_cons} padded constraints): cold {walls[0]:.4f}s "
        f"(capture and instantiation {g['capture_s']:.4f}s, pool {g['pool_mib']:.1f} MiB), "
        f"replay {walls[1]:.4f}s, byte-equal to hybrid.prove_zk, verified")


def _mono_cards(rec: dict, tmp: str) -> None:
    """With two cards or more: cli.run_lp(mesh='auto') under
    OTTI_MESH_MONOLITHIC=1 (shards on distinct cards: uncaptured, meta
    graph false), then the CLI as two NCCL ranks, a card a rank, under it
    (each rank's core captured, meta graph true)."""
    from otti_tpu_torch import cli
    from otti_tpu_torch.spartan import hybrid, serial

    cards = torch.cuda.device_count()
    if cards < 2:
        log("[mono] one card visible: the CLI over distinct cards and NCCL ranks not run")
        return
    lp = os.path.join(tmp, "gen117x225.mps")
    write_lp_mps(lp, 117, 225, seed=1)
    k = 1 << (cards.bit_length() - 1)
    os.environ["OTTI_MESH_MONOLITHIC"] = "1"
    try:
        ok, _ = _captured("mono:cli", cli.run_lp, [lp], os.path.join(tmp, "mono"), zk=True,
                          mesh="auto")
    finally:
        del os.environ["OTTI_MESH_MONOLITHIC"]
    if not ok:
        raise AssertionError("run_lp(mesh='auto') under OTTI_MESH_MONOLITHIC=1 did not verify")
    meta = _check_meta("mono:cli", os.path.join(tmp, "mono", "LP", "gen117x225.mps.meta.json"),
                       f"zk-mesh{k}")
    if meta["graph"] is not False:
        raise AssertionError("[mono:cli] shards on distinct cards were captured")
    log(f"[mono:cli] run_lp(mesh='auto') under OTTI_MESH_MONOLITHIC=1 over {k} cards: meta mode "
        f"zk-mesh{k}, graph false (uncaptured)")
    shape, v, i = _lower_lp(lp)
    plain_ref = serial.dumps(hybrid.prove(shape.to_device("cuda"), v, i))
    _dist_cli(rec, tmp, lp, 2, "nccl", plain_ref, mono=True)
    for world in (2, 4) if cards >= 4 else (2,):
        tag, port, t0 = f"mono:nccl:W={world}", _free_port(), time.time()
        outs = [os.path.join(tmp, f"mono_worker_{world}_{r}.json") for r in range(world)]
        _run_ranks(tag, [[sys.executable, os.path.abspath(__file__), "--mono-worker",
                          f"{r},{world},{port},{tmp},{outs[r]}"] for r in range(world)],
                   _rank_env(world, False))
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
        rec.setdefault("mono_nccl", {})[f"W{world}"] = ranks
        log(f"[{tag}] {world} ranks (NCCL, a card a rank, each rank's core captured: "
            f"{[r['graph'] for r in ranks]}), {time.time() - t0:.1f}s: warm zk replay medians "
            + ", ".join(f"rank {r['rank']} {r['warm']['median']:.4f}s" for r in ranks)
            + "; graphs " + json.dumps(ranks[0]["graphs"]))


def _mono_worker(spec: str) -> int:
    """One rank of phase mono's NCCL run: the two LPs 117 x 225 over W
    ranks by fused_prover, zk (a seed an LP) and plain, each rank's core
    captured (LP 1 cold, LP 2 replayed through its graph), every proof
    byte-equal to hybrid's on this rank's card; then MONO_RUNS warm zk
    replays.  Writes its record (JSON) to the path in ``spec``."""
    import torch.distributed as dist

    from otti_tpu_torch import runtime
    from otti_tpu_torch.parallel import fused_prover as FP
    from otti_tpu_torch.spartan import hybrid, serial

    rank, world, port, tmp, out = spec.split(",")
    rank, world = int(rank), int(world)
    runtime.init_distributed(f"127.0.0.1:{port}", world, rank, "cuda")
    group, card = dist.group.WORLD, torch.device("cuda", torch.cuda.current_device())
    tag = f"mono:rank{rank}"
    here = os.path.join(tmp, f"mono_rank{rank}")
    os.makedirs(here, exist_ok=True)
    insts = _mono_lps(here, card)
    rec = {"rank": rank, "backend": dist.get_backend(), "graph": FP.captures([card], group)}
    if not rec["graph"]:
        raise AssertionError(f"[{tag}] an NCCL rank's core is not captured")

    def mono(n, zk):
        d, v, i = insts[n]
        if zk:
            return lambda: FP.prove_zk(d, v, i, k=world, seed=MONO_SEEDS[n], group=group)
        return lambda: FP.prove(d, v, i, k=world, group=group)

    for zk in (True, False):
        for n, (d, v, i) in enumerate(insts):
            got = serial.dumps(mono(n, zk)())
            want = serial.dumps(hybrid.prove_zk(d, v, i, seed=MONO_SEEDS[n]) if zk
                                else hybrid.prove(d, v, i))
            if got != want:
                raise AssertionError(f"[{tag}] LP {n + 1} {'zk' if zk else 'plain'} over {world} "
                                     "ranks is not hybrid's")
    graphs = FP.graphs()
    if len(graphs) != 2 or any(g["replays"] != 2 for g in graphs):
        raise AssertionError(f"[{tag}] expected one graph a mode, replayed for both LPs: {graphs}")
    walls, _, _ = _warm_runs(mono(0, True), MONO_RUNS)
    rec.update(warm=_spread(walls), graphs=graphs)
    log(f"[{tag}] both LPs, zk and plain, over {world} NCCL ranks byte-equal to hybrid's on "
        f"{card}; LP 2 replayed through LP 1's graph; warm zk {_show(rec['warm'])}")
    FP.clear_graphs()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def phase_mono_cards(rec: dict) -> None:
    """Phase mono's part over several cards alone (development: a
    four-card call that runs only what needs the cards)."""
    with tempfile.TemporaryDirectory() as tmp:
        _mono_cards(rec, tmp)


def phase_mono(rec: dict) -> None:
    """The single-dispatch sharded provers (parallel/fused_prover.py, the
    CLI's --mesh under OTTI_MESH_MONOLITHIC=1): the LP 117 x 225 zk and
    plain at k = 1, 2, 4 shards on cuda:0, captured and replayed, against
    hybrid and hybrid_sharded; optdigits zk at k = 2; with two cards or
    more the CLI over distinct cards and as two NCCL ranks."""
    from otti_tpu_torch.parallel import fused_prover as FP

    card = torch.device("cuda", 0)
    FP.clear_graphs()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        insts = _mono_lps(tmp, card)
        log(f"[mono] two LPs 117 x 225 (seeds 1, 2; one class, {insts[0][0].num_cons} padded "
            f"constraints) lowered in {time.time() - t0:.1f}s")
        _mono_lp(rec, insts, card)
        t0 = time.time()
        _mono_optdigits(rec, tmp, card)
        log(f"[mono] optdigits {time.time() - t0:.1f}s")
        FP.clear_graphs()
        torch.cuda.empty_cache()
        t0 = time.time()
        _mono_cards(rec, tmp)
        log(f"[mono] over several cards {time.time() - t0:.1f}s")


ZR_LABELS = {3: b"sc1", 2: b"sc2"}  # the zk phases' labels by degree


def _round_permutations(label: bytes, degree: int) -> int:
    """Keccak-f permutations of one zk round's transcript steps from the
    post-challenge offsets, counted on the host Merlin."""
    from otti_tpu_torch.spartan import zk_round_kernel as ZR
    from otti_tpu_torch.transcript import device as TD
    from otti_tpu_torch.transcript.merlin import transcript_from_strobe_state

    t = transcript_from_strobe_state(bytes(200), *TD.POST_CHALLENGE)
    count = [0]
    run_f = t.strobe._run_f

    def counted():
        count[0] += 1
        run_f()

    t.strobe._run_f = counted
    ZR.transcript_steps(t, ZR.round_labels(label), degree)
    return count[0]


def _zk_round_case(degree: int, batch: int, seed: int, card) -> tuple:
    """A round's inputs on the card, semi-form claims: (e, be, evs, xs,
    state); ``batch`` 0: no leading axis."""
    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.field.fields import SCALAR

    gen = torch.Generator().manual_seed(seed)
    lead = (batch,) if batch else ()
    m = SCALAR.modulus

    def scalars(*shape):
        n = int(np.prod(lead + shape))
        vals = [int.from_bytes(torch.randint(0, 256, (32,), generator=gen).to(torch.uint8)
                               .numpy().tobytes(), "little") % m for _ in range(n)]
        return F.from_ints(SCALAR, vals, card).reshape(lead + shape + (22,))

    def semi(x):
        return _semi(x.reshape(-1, 22), gen).reshape(x.shape)

    evs = scalars(degree)
    e, be = semi(scalars()), semi(scalars())
    xs = (scalars(), scalars(), scalars(degree + 1), scalars(), scalars())
    state = torch.randint(0, 256, lead + (200,), generator=gen).to(torch.uint8).to(card)
    return e, be, evs, xs, state


def phase_zk_round(rec: dict) -> None:
    """Kernel K6 against the torch round on the card, then both timed beside
    the parts of its floor (K4 on two points, K3 on one state)."""
    from otti_tpu_torch.curve import edwards as E
    from otti_tpu_torch.curve import ristretto as R
    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.field.fields import SCALAR
    from otti_tpu_torch.spartan import zk_round_kernel as ZR
    from otti_tpu_torch.spartan import zkfused as ZF
    from otti_tpu_torch.transcript import device as TD

    card = torch.device("cuda", 0)

    def transcript(state):
        return TD.DeviceTranscript(_strobe=TD.DeviceStrobe(_raw=(state, *TD.POST_CHALLENGE)))

    def run(fn, degree, case):
        e, be, evs, xs, state = case
        t = transcript(state.clone())
        e_next, _, r, encs, z, zdb = fn(ZR_LABELS[degree], degree, ZF._round_tables(degree, card),
                                        t, e, be, evs, xs)
        return [F.canon(SCALAR, e_next), r, encs, z, zdb, t.strobe.state]

    for degree in (3, 2):
        for batch in (0, 8):
            case = _zk_round_case(degree, batch, 1000 + 10 * degree + batch, card)
            got = run(ZF._zk_round_from_evals, degree, case)
            want = run(ZF._zk_round_plain, degree, case)
            for name, g, w in zip(("e_next", "r", "encs", "z", "zdb", "state"), got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"[zk_round] K6 != torch round in {name} at degree "
                                         f"{degree}, B = {max(batch, 1)}")
    log("[zk_round] K6 == the torch round at degree 3 and 2, B = 1 and 8: e_next, r, encs, z, "
        "zdb and the sponge state")

    # the floor's parts: K4 on two points, K3 on one state at the post-challenge pad
    pts = E.tree_map(lambda a: a.contiguous(), E.base_point((2,), card))
    k4_ms = cuda_ms(lambda: R.encode_cuda(pts), 200, queue_ahead=True)
    st = torch.zeros((1, 200), dtype=torch.uint8, device=card)
    k3_ms = cuda_ms(lambda: TD.keccak_f1600_cuda(st, *TD.POST_CHALLENGE[:2]), 200,
                    queue_ahead=True)
    out = {}
    for degree in (3, 2):
        label = ZR_LABELS[degree]
        perms = _round_permutations(label, degree)
        e, be, evs, xs, state = _zk_round_case(degree, 0, 7 + degree, card)
        t = transcript(state.clone())
        tbl = ZF._round_tables(degree, card)
        vinv = ZF._vandermonde_inv_limbs(degree, card)
        k6 = lambda: ZR.zk_round_cuda(label, degree, tbl["p"], vinv, t, e, be, evs, xs)  # noqa
        ms = cuda_ms(k6, 100, queue_ahead=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            k6()
        torch.cuda.synchronize()
        wrapper_ms = (time.perf_counter() - t0) * 10
        plain = lambda: ZF._zk_round_plain(label, degree, tbl, t, e, be, evs, xs)  # noqa: E731
        plain_ms = cuda_ms(plain, 5, queue_ahead=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            plain()
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 200
        eb, beb, evsb, xsb, stateb = _zk_round_case(degree, 8, 17 + degree, card)
        tb = transcript(stateb.clone())
        batch8_ms = cuda_ms(lambda: ZR.zk_round_cuda(label, degree, tbl["p"], vinv, tb, eb, beb,
                                                     evsb, xsb), 50, queue_ahead=True)
        floor_ms = 3 * k4_ms + perms * k3_ms
        # operations: the gathered entries (each t = x y and an addition of
        # 10 BASE multiplies), five encodings, the permutations
        nc = degree + 1
        entries = 32 * (2 * (nc + 1) + 2 + 4)
        n_ops = (2 * WIDE_MULS["base"] * (11 * entries + 5 * ENCODE_MULS)
                 + perms * KECCAK_OPS)
        bnd, by = ops_bound(n_ops, entries * 64 + (3 * nc + 8) * ROW_BYTES + 2 * 200)
        out[degree] = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                           plain_wall_ms=plain_wall_ms, batch8_ms=batch8_ms, floor_ms=floor_ms,
                           bound_ms=bnd, bound_by=by, permutations=perms)
        log(f"[zk_round] degree {degree}: K6 {ms:.4f} ms (wrapper {wrapper_ms:.4f}; B = 8 "
            f"{batch8_ms:.4f}) against the torch round {plain_ms:.4f} ms of device time "
            f"({plain_wall_ms:.2f} ms a round, host-paced); floor {floor_ms:.4f} ms = 3 x K4 "
            f"{k4_ms:.5f} + {perms} x K3 {k3_ms:.5f}; bound {bnd:.6f} ms ({by})")
    rec["zk_round"] = dict(out[3], max_abs_err=0, quad=out[2], k4_ms=k4_ms, k3_ms=k3_ms)



def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--tree", help="import otti_tpu_torch from this checkout instead (to time "
                                   "another commit's package in the same call)")
    ap.add_argument("--dist-worker", metavar="RANK,WORLD,PORT,LP,OUT",
                    help="run one rank of phase dist (the phase starts these itself)")
    ap.add_argument("--mono-worker", metavar="RANK,WORLD,PORT,DIR,OUT",
                    help="run one rank of phase mono's NCCL run (the phase starts these itself)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else REPO)
    if args.dist_worker:
        return _dist_worker(args.dist_worker)
    if args.mono_worker:
        return _mono_worker(args.mono_worker)
    rec: dict = {}
    fns = {"device": phase_device, "build": phase_build, "kernel1": phase_kernel1,
           "kernel2": phase_kernel2, "main": phase_main, "cpu_gpu": phase_cpu_gpu,
           "scale": phase_scale, "lp_sdp": phase_lp_sdp, "snark": phase_snark,
           "custom": phase_custom, "snark_warm": phase_snark_warm, "device_fs": phase_device_fs, "profile": phase_profile, "batch": phase_batch,
           "mesh": phase_mesh, "dist": phase_dist, "mono": phase_mono,
           "mono_cards": phase_mono_cards, "zk_round": phase_zk_round}
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
        ("keccak", "keccak_f1600", "otti_tpu_torch/csrc/keccak.cu",
         "otti_tpu/transcript/device.py:92"),
        ("ristretto", "ristretto_encode", "otti_tpu_torch/csrc/ristretto_encode.cu",
         "otti_tpu/curve/ristretto.py:61"),
        ("custom", "custom_round", "otti_tpu_torch/csrc/custom_round.cu",
         "otti_tpu/spartan/sumcheck.py:202"),
        ("zk_round", "zk_round", "otti_tpu_torch/csrc/zk_round.cu",
         "otti_tpu/spartan/zkfused.py:130"),
    ):
        # K5's path is SNARK mode (phase snark); the others' the CLI's zk default
        path = rec.get("launches_snark", {}) if key == "custom" else launches
        if key in rec:
            kernels.append({"name": cname, "route": "cuda", "source": src, "replaces": rep,
                            "launches": path.get(cname, 0),
                            "max_abs_err": rec[key]["max_abs_err"],
                            "ms": rec[key]["ms"], "plain_ms": rec[key]["plain_ms"],
                            "bound_ms": rec[key]["bound_ms"],
                            "bound_by": rec[key]["bound_by"],
                            "library_ms": None,  # no PyTorch call computes any of these functions
                            "wrapper_ms": rec[key]["wrapper_ms"],
                            "launches_transparent":
                                rec.get("launches_transparent", {}).get(cname),
                            "launches_lp_sdp": rec.get("launches_lp_sdp", {}).get(cname),
                            "launches_snark": rec.get("launches_snark", {}).get(cname),
                            "launches_device_fs":
                                rec.get("launches_device_fs", {}).get(cname),
                            "launches_batch": rec.get("launches_batch", {}).get(cname),
                            "launches_mesh": rec.get("launches_mesh", {}).get(cname),
                            # rank 0 of two on the one card, the dist phase's main path
                            "launches_dist": rec.get("launches_dist", {}).get(cname),
                            # a cold zk prove by fused_prover at k = 2: warm-up and capture
                            "launches_mono": rec.get("launches_mono", {}).get(cname),
                            "launches_mono_graph": rec.get("mono", {}).get("zk-k2", {}).get(
                                "graph", {}).get("launches", {}).get(cname),
                            **{k: v for k, v in rec[key].items()
                               if k in ("base", "quad", "fs_ms", "fs_wrapper_ms", "fs_plain_ms",
                                        "floor_ms", "sizes", "shapes", "batch8_ms",
                                        "plain_wall_ms", "permutations")},
                            **({"device_challenge": rec["kernel2_device_challenge"]}
                               if key == "kernel2" and "kernel2_device_challenge" in rec
                               else {}),
                            **({"batched": rec["kernel2_batched"]}
                               if key == "kernel2" and "kernel2_batched" in rec else {}),
                            **({"mesh": rec["kernel2_mesh"]}
                               if key == "kernel2" and "kernel2_mesh" in rec else {}),
                            "launches_per_prove": {
                                tag: per.get(cname)
                                for tag, per in rec.get("launches_per_prove", {}).items()}})
    log(rec.get("smi", ""))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
