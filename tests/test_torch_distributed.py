"""The port across processes: two ``gloo`` ranks on the CPU, joined by
``runtime.init_distributed`` over a localhost rendezvous.

This file's ``__main__`` is the worker, run as two subprocesses (a free
port each pair, 240 s at most, killed on expiry).  Each rank:
- runs ``sharded.round_cubic_sharded`` on a mesh of one shard a rank (the
  counterpart of tests/distributed_worker.py), held here against Python
  integers and against the JAX package's round on one device;
- proves ``__graft_entry__._toy_r1cs`` (16 constraints, 8 variables) by
  ``hybrid_sharded.prove`` and ``prove_zk(seed=S)`` across the two ranks,
  which must give, on both ranks, the bytes of ``hybrid.prove`` /
  ``hybrid.prove_zk(seed=S)`` in one process and of the JAX package's
  ``nizk.prove`` / ``zknizk.prove(seed=S)`` on the same instance, and
  ``prove_zk`` without a seed, which must give one proof on both ranks
  (rank 0's seed), verified;
- proves the same instance by ``fused_prover.prove`` and ``prove_zk(seed=S)``
  across the two ranks (the core uncaptured, as a gloo group runs it),
  which must give the same bytes.
Two more subprocesses run the command line as ranks 0 and 1 (``--mesh 2
--transparent`` on the 8x3 SGD instance): both verify, only rank 0 writes
``--out``, and its proof is the JAX command line's.  A second such pair,
with ``--resume`` and each rank its own ``--out``, skips the instance on
both ranks, as rank 0's ``--out`` says it verified.  The flags' errors,
the backend rule and the count of ranks a host are held in this process.
Tolerance: exact equality.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from otti_tpu_torch import cli, runtime
from otti_tpu_torch.field.fields import SCALAR
from otti_tpu_torch.spartan import r1cs as TR

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = SCALAR.modulus
SEED = b"\x5a" * 32
TIMEOUT = 240


def _tables() -> list:
    """The round's four tables (8 elements: 4 a rank), from a seed."""
    rng = np.random.default_rng(42)
    return [[int.from_bytes(rng.bytes(32), "little") % M for _ in range(8)] for _ in range(4)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(argv_of_rank, env) -> list:
    """Two subprocesses, ranks 0 and 1 -> [(rc, stdout, stderr)]; both are
    killed if either outlives TIMEOUT."""
    env = dict(env, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(argv_of_rank(r), cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _jax_proofs(tmp, cfg) -> dict:
    """The JAX package's proofs: of the workers' instance, and the JAX
    command line's run function's proof of the 8x3 instance on one device
    (its host-transcript prover, the same bytes; the JAX parser has no
    --config)."""
    from otti_tpu import cli as jcli
    from otti_tpu.spartan import nizk as JN
    from otti_tpu.spartan import serial as JS
    from otti_tpu.spartan import zknizk as JZ

    shape, zvars = graft._toy_r1cs()
    dev = shape.to_device()
    res = {"plain": JS.dumps(JN.prove(dev, zvars, [])),
           "zk": JS.dumps(JZ.prove(dev, zvars, [], seed=SEED))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMLB_CACHE_DIR", str(tmp / "cache"))
        mp.setenv("OTTI_CLASSIC", "1")
        assert jcli.run_sgd(str(cfg), str(tmp / "jax"), zk=False)
    res["cli"] = (tmp / "jax" / "SGD" / "tiny8x3.proof.json").read_text()
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker pair and the command-line pairs, side by side, and the JAX
    package's proofs meanwhile in this process."""
    from tests.test_torch_device_fs import _sgd_small

    tmp = tmp_path_factory.mktemp("dist")
    root = tmp / "cache" / "tiny8x3"
    root.mkdir(parents=True)
    X, y = _sgd_small()
    with open(root / "tiny8x3.tsv", "w") as f:
        f.write("a\tb\tc\ttarget\n")
        for row, label in zip(X, y):
            f.write("\t".join(str(int(v)) for v in row) + f"\t{1 if label == 1 else 0}\n")
    cfg = tmp / "tiny.json"
    cfg.write_text(json.dumps(
        {"tiny8x3": {"classes": [1, 0], "seed": 0, "eta0": 0.1, "maxiter": 1000, "tol": 1e-4}}))
    p_work, p_cli, p_resume = _free_port(), _free_port(), _free_port()
    # the subprocesses' environment, taken before _jax_proofs sets its own here
    env = dict(os.environ)
    from concurrent.futures import ThreadPoolExecutor

    def cli_pair(port, *flags):
        return _run_pair(lambda r: [
            sys.executable, "-m", "otti_tpu_torch.cli", "--sgd", "--config", str(cfg),
            "--transparent", "--device", "cpu", "--mesh", "2", "--coordinator",
            f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id", str(r),
            "--out", str(tmp / f"out{r}"), *flags], dict(env, PMLB_CACHE_DIR=str(tmp / "cache")))

    with ThreadPoolExecutor(2) as ex:
        work = ex.submit(_run_pair, lambda r: [sys.executable, os.path.abspath(__file__), str(r),
                                               str(p_work), str(tmp / f"rank{r}.json")], env)
        # the resumed pair runs once the first has written rank 0's --out
        clis = ex.submit(lambda: (cli_pair(p_cli), cli_pair(p_resume, "--resume")))
        jax_proofs = _jax_proofs(tmp, cfg)
        work, (clis, resumed) = work.result(), clis.result()
    for rc, out, err in work:
        assert rc == 0, f"worker rc={rc}\n{out[-2000:]}\n{err[-3000:]}"
    return {"tmp": tmp, "jax": jax_proofs, "cli": clis, "resumed": resumed,
            "work": [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]}


def test_round_across_processes_matches_host_and_jax(runs):
    import jax
    import jax.numpy as jnp

    from otti_tpu.field import fields as JF
    from otti_tpu.field import ops as JO
    from otti_tpu.parallel import sharded as JS

    tabs = _tables()

    def ext(vals, t):
        return [(a + t * (b - a)) % M for a, b in zip(vals[0::2], vals[1::2])]

    host = []
    for t in (0, 2, 3):
        eqt, at, bt, ct = (ext(v, t) for v in tabs)
        host.append(sum(e * (a * b - c) for e, a, b, c in zip(eqt, at, bt, ct)) % M)

    @jax.jit
    def jax_round(eq, a, b, c):  # the JAX module's round on one device
        outs = []
        for t in (0, 2, 3):
            eqt, at, bt, ct = (JS._ext_lsb(x, t) for x in (eq, a, b, c))
            outs.append(JO.dot(JF.SCALAR, eqt, JO.sub(JF.SCALAR, JO.mul(JF.SCALAR, at, bt), ct)))
        return jnp.stack(outs)

    got = jax_round(*(jnp.asarray(JF.ints_to_limbs(t)) for t in tabs))
    jax_vals = [JF.limbs_to_int(row) % M for row in np.asarray(got)]
    assert runs["work"][0]["round"] == runs["work"][1]["round"] == host == jax_vals


@pytest.mark.parametrize("mode", ["plain", "zk"])
def test_proofs_across_processes_equal_one_process(runs, mode):
    """hybrid_sharded over two ranks == hybrid in one process == the JAX
    package's prover, on each rank."""
    shape_j, _ = graft._toy_r1cs()
    assert TR.random_satisfiable()[0].digest() == shape_j.digest()
    for rank in runs["work"]:
        assert rank[mode] == rank[f"{mode}_single"] == runs["jax"][mode]
        assert rank[f"{mode}_verified"]


@pytest.mark.parametrize("mode", ["plain", "zk"])
def test_fused_prover_across_processes_equals_one_process(runs, mode):
    """fused_prover over two gloo ranks (its core uncaptured: gloo stages
    through host memory) == hybrid in one process == the JAX package's
    prover, on each rank."""
    for rank in runs["work"]:
        assert rank["mono_graph"] is False
        assert rank[f"mono_{mode}"] == rank[f"{mode}_single"] == runs["jax"][mode]


def test_zk_blind_seed_is_rank_0s(runs):
    a, b = runs["work"]
    assert a["zk_drawn"] == b["zk_drawn"] and a["zk_drawn_verified"]
    assert a["zk_drawn"] != a["zk"]  # a fresh seed, not S


def test_cli_across_processes(runs):
    tmp = runs["tmp"]
    for r, (rc, out, err) in enumerate(runs["cli"]):
        assert rc == 0, f"rank {r} rc={rc}\n{out[-2000:]}\n{err[-3000:]}"
        assert f"Rank {r} of 2 (gloo) on cpu" in out
        assert "Verification successful for tiny8x3" in out
    assert not (tmp / "out1").exists()
    with open(tmp / "out0" / "SGD" / "tiny8x3.meta.json") as f:
        meta = json.load(f)
    assert meta["mode"] == "plain-mesh2" and meta["verified"]
    assert (meta["rank"], meta["world_size"], meta["dist_backend"], meta["card"]) == (
        0, 2, "gloo", "cpu")


def test_cli_proof_across_processes_is_the_jax_clis(runs):
    """Rank 0's proof of the 8x3 instance == the JAX command line's."""
    assert (runs["tmp"] / "out0" / "SGD" / "tiny8x3.proof.json").read_text() == runs["jax"]["cli"]


def test_cli_resume_follows_rank_0(runs):
    """--resume with an --out a rank: rank 0's says the instance verified,
    rank 1's is empty, and both ranks skip it (else rank 1 would prove
    alone and wait for rank 0 in its first exchange)."""
    for r, (rc, out, err) in enumerate(runs["resumed"]):
        assert rc == 0, f"rank {r} rc={rc}\n{out[-2000:]}\n{err[-3000:]}"
        assert "Skipping tiny8x3 (already verified)" in out
        assert "Proving tiny8x3" not in out
    assert not (runs["tmp"] / "out1").exists()


@pytest.mark.parametrize("flags,needle", [
    (["--num-hosts", "2", "--host-id", "0", "--mesh", "4"],
     "--mesh 4 in a process group of 2 ranks"),
    (["--num-hosts", "2", "--coordinator", "127.0.0.1:1"],
     "--coordinator, --num-hosts and --host-id go together"),
])
def test_cli_group_flag_errors(tmp_path, capsys, flags, needle):
    flags = flags + ([] if "--coordinator" in flags else ["--coordinator", "127.0.0.1:1"])
    with pytest.raises(SystemExit) as err:
        cli.main(["--sgd", "--device", "cpu", "--out", str(tmp_path / "o")] + flags)
    assert err.value.code == 2
    assert needle in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_init_distributed_without_flags_or_launcher_is_a_noop(monkeypatch):
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert runtime.init_distributed(device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,on_host,cards,backend", [
    ("cpu", 1, 0, "gloo"),
    ("cpu", 2, 4, "gloo"),
    ("cuda", 1, 1, "nccl"),  # one rank a host, each with its one card (two hosts)
    ("cuda", 2, 1, "gloo"),  # two ranks sharing one card
    ("cuda", 4, 4, "nccl"),
    ("cuda", 5, 4, "gloo"),
])
def test_backend_rule(monkeypatch, device, on_host, cards, backend):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert runtime.backend_for(device, on_host) == backend


def test_host_ranks_counts_the_ranks_of_each_host():
    """Rank 1 of 3 here, rank 0 on another host, rank 2 on this one: two
    ranks share this host and rank 1 is the first of them."""
    import torch.distributed as dist

    store = dist.HashStore()
    store.set("otti/host/0", "another-host")
    store.set("otti/host/2", socket.gethostname())
    assert runtime.host_ranks(store, 1, 3) == (2, 0)
    assert runtime.host_ranks(store, 2, 3) == (2, 1)


def _worker(rank: int, port: str, out: str) -> None:
    """Rank ``rank`` of two: the round, then the proofs; results to ``out``."""
    import torch.distributed as dist

    from otti_tpu_torch.field import ops as F
    from otti_tpu_torch.parallel import fused_prover as FP
    from otti_tpu_torch.parallel import hybrid_sharded as HS
    from otti_tpu_torch.parallel import sharded
    from otti_tpu_torch.spartan import hybrid, nizk, serial, zknizk

    assert runtime.init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    group = dist.group.WORLD
    res = {}
    mesh = sharded.make_mesh(device="cpu", group=group)
    assert (mesh.sp, mesh.first) == (2, rank)
    tabs = [sharded.shard(mesh, F.from_ints(SCALAR, t)) for t in _tables()]
    res["round"] = [F.to_int(SCALAR, e) for e in sharded.round_cubic_sharded(mesh, *tabs)]

    shape, zvars = TR.random_satisfiable()
    dev = shape.to_device("cpu")
    plain = HS.prove(dev, zvars, [], k=2, group=group)
    res["plain"], res["plain_single"] = serial.dumps(plain), serial.dumps(hybrid.prove(dev, zvars, []))
    res["plain_verified"] = nizk.verify(dev, [], plain)
    zk = HS.prove_zk(dev, zvars, [], k=2, seed=SEED, group=group)
    res["zk"], res["zk_single"] = (serial.dumps(zk),
                                   serial.dumps(hybrid.prove_zk(dev, zvars, [], seed=SEED)))
    res["zk_verified"] = zknizk.verify(dev, [], zk)
    drawn = HS.prove_zk(dev, zvars, [], group=group)
    res["zk_drawn"], res["zk_drawn_verified"] = serial.dumps(drawn), zknizk.verify(dev, [], drawn)
    # the single-dispatch provers over the two ranks (gloo: uncaptured)
    res["mono_graph"] = FP.captures([dev.device], group)
    res["mono_plain"] = serial.dumps(FP.prove(dev, zvars, [], k=2, group=group))
    res["mono_zk"] = serial.dumps(FP.prove_zk(dev, zvars, [], k=2, seed=SEED, group=group))
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
