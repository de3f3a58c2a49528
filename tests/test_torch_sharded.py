"""The port's parallel/sharded.py against the JAX package's, as
tests/test_parallel.py holds the JAX one: k = 2, 4 and 8 shards.

The inputs are made from a seed with numpy: four tables of 32 elements for
a cubic round, one of 16 for a bind, 24 COO entries of an 8 x 16 matrix
with z for the matvec, and 16 points k * B with scalars for the MSM.  The
JAX functions run on the conftest's 8 CPU devices in a fresh interpreter
(this file's ``__main__``, started when the module starts): a late
``shard_map`` compile in a long-lived process is what
tests/test_zz_multidevice_isolated.py keeps apart, and the child's
compiles overlap the port's cases.  The round, the bind and the matvec are
compiled at each k; the MSM (a ``pippenger.msm`` a shard, 30 s of compile)
at k = 2, whose sum is the same group element at every k.  The port's
shards sit on the CPU (the multiply's plain version); each result is also
held against Python integers or the host library.  Tolerance: exact
equality of canonical values and of group elements.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from otti_tpu_torch import native
from otti_tpu_torch.curve import edwards as E
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.field.fields import SCALAR
from otti_tpu_torch.parallel import sharded as S
from otti_tpu_torch.refimpl import numeric as ref

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = SCALAR.modulus
KS = [2, 4, 8]
CPU = torch.device("cpu")


def _ints(rng, n: int, mod: int = M) -> list:
    return [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]


def _inputs() -> dict:
    rng = np.random.default_rng(2024)
    nnz, n_cons, n_z = 24, 8, 16
    return {
        "round": [_ints(rng, 32) for _ in range(4)],
        "bind": {"table": _ints(rng, 16), "r": _ints(rng, 1)[0]},
        "matvec": {"rows": [int(x) for x in rng.integers(0, n_cons, nnz)],
                   "cols": [int(x) for x in rng.integers(0, n_z, nnz)],
                   "vals": _ints(rng, nnz), "z": _ints(rng, n_z), "num_cons": n_cons},
        "msm": {"points": [[p.X, p.Y, p.Z, p.T] for p in
                           (native.scalar_mul_host(ref.EdPoint.base(), k)
                            for k in _ints(rng, 16, ref.L))],
                "scalars": _ints(rng, 16, ref.L), "window": 4},
    }


INPUTS = _inputs()


class _JaxRef:
    """The JAX results, computed by a child interpreter started at once."""

    def __init__(self, tmp):
        self.inp, self.out = tmp / "in.json", tmp / "out.json"
        self.inp.write_text(json.dumps(INPUTS))
        flags = os.environ.get("XLA_FLAGS", "")
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(flags + " --xla_force_host_platform_device_count=8").strip())
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(self.inp),
                                      str(self.out)], cwd=REPO, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.got = None

    def __getitem__(self, key: str):
        if self.got is None:
            try:
                _, err = self.proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, err[-3000:]
            self.got = json.loads(self.out.read_text())
        return self.got[key]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    ref_ = _JaxRef(tmp_path_factory.mktemp("jax_sharded"))
    yield ref_
    ref_.close()


def _vec(xs: list) -> torch.Tensor:
    return F.from_ints(SCALAR, xs)


def _canon(x: torch.Tensor) -> list:
    return F.to_ints(SCALAR, F.canon(SCALAR, x.reshape(-1, 22)))


def _ext(vals: list, t: int) -> list:
    return [(a + t * (b - a)) % M for a, b in zip(vals[0::2], vals[1::2])]


def _mesh(k: int) -> S.Mesh:
    return S.make_mesh(k, device="cpu")


def test_make_mesh_and_shard_round_trip():
    mesh = S.make_mesh(8, dp=2, device="cpu")
    assert (mesh.sp, mesh.devices, mesh.first, mesh.group) == (4, (CPU,) * 4, 0, None)
    assert S.make_mesh(device="cpu").sp == 1
    x = _vec(INPUTS["bind"]["table"])
    parts = S.shard(mesh, x)
    assert [p.shape[0] for p in parts] == [4] * 4 and torch.equal(S.unshard(mesh, parts), x)
    with pytest.raises(ValueError, match="do not split into 4 shards"):
        S.shard(mesh, x[:6])


@pytest.mark.parametrize("k", KS)
def test_round_cubic_sharded_matches_jax(jax_ref, k):
    tabs = INPUTS["round"]
    mesh = _mesh(k)
    got = S.round_cubic_sharded(mesh, *(S.shard(mesh, _vec(t)) for t in tabs))
    want = []
    for t in (0, 2, 3):
        eqt, at, bt, ct = (_ext(v, t) for v in tabs)
        want.append(sum(e * (a * b - c) for e, a, b, c in zip(eqt, at, bt, ct)) % M)
    assert [_canon(e)[0] for e in got] == want == jax_ref[f"round-{k}"]


@pytest.mark.parametrize("k", KS)
def test_bind_sharded_matches_jax(jax_ref, k):
    tbl, r = INPUTS["bind"]["table"], INPUTS["bind"]["r"]
    mesh = _mesh(k)
    (bound,) = S.bind_sharded(mesh, _vec([r])[0], S.shard(mesh, _vec(tbl)))
    assert _canon(S.unshard(mesh, bound)) == _ext(tbl, r) == jax_ref[f"bind-{k}"]


@pytest.mark.parametrize("k", KS)
def test_matvec_sharded_matches_jax(jax_ref, k):
    mv = INPUTS["matvec"]
    mesh = _mesh(k)
    rows, cols = (S.shard(mesh, torch.tensor(mv[c])) for c in ("rows", "cols"))
    got = S.matvec_sharded(mesh, rows, cols, S.shard(mesh, _vec(mv["vals"])), _vec(mv["z"]),
                           mv["num_cons"])
    want = [0] * mv["num_cons"]
    for r, c, v in zip(mv["rows"], mv["cols"], mv["vals"]):
        want[r] = (want[r] + v * mv["z"][c]) % M
    assert _canon(got) == want == jax_ref[f"matvec-{k}"]


@pytest.mark.parametrize("k", KS)
def test_msm_sharded_matches_jax(jax_ref, k):
    ms = INPUTS["msm"]
    mesh = _mesh(k)
    pts_ref = [ref.EdPoint(*p) for p in ms["points"]]
    pts = E.stack([E.from_ref(p) for p in pts_ref])
    blocks = [E.tree_map(lambda a, i=i: a[i], {c: S.shard(mesh, pts[c]) for c in E.COORDS})
              for i in range(k)]
    got = E.to_ref(S.msm_sharded(mesh, blocks, S.shard(mesh, _vec(ms["scalars"])),
                                 window=ms["window"]))
    assert got == native.msm_host(pts_ref, ms["scalars"]) == ref.EdPoint(*jax_ref["msm-2"])


def _jax_main(inp: str, out: str) -> None:
    """Child interpreter: the JAX package's sharded functions on 8 CPU
    devices, every case of ``inp``."""
    import functools

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from otti_tpu import runtime
    from otti_tpu.curve import edwards as JE
    from otti_tpu.field import fields as JF
    from otti_tpu.parallel import sharded
    from otti_tpu.refimpl import numeric as jref

    runtime.enable_compile_cache()
    runtime.allow_multidevice_cache()
    cfg = json.loads(open(inp).read())

    def vec(xs):
        return jnp.asarray(JF.ints_to_limbs(xs))

    def ints(x):  # any limb form (a psum leaves sums of several), reduced on the host
        return [JF.limbs_to_int(row) % M for row in np.asarray(x).reshape(-1, 22)]

    res = {}
    for k in KS:
        mesh = sharded.make_mesh(k)
        put = functools.partial(jax.device_put, device=NamedSharding(mesh, P("sp", None)))
        put1 = functools.partial(jax.device_put, device=NamedSharding(mesh, P("sp")))
        evals = jax.jit(functools.partial(sharded.round_cubic_sharded, mesh))(
            *(put(vec(t)) for t in cfg["round"]))
        res[f"round-{k}"] = [ints(e)[0] for e in evals]
        bd = cfg["bind"]
        (bound,) = jax.jit(functools.partial(sharded.bind_sharded, mesh))(
            vec([bd["r"]])[0], put(vec(bd["table"])))
        res[f"bind-{k}"] = ints(bound)
        mv = cfg["matvec"]
        got = jax.jit(functools.partial(sharded.matvec_sharded, mesh, num_cons=mv["num_cons"]))(
            put1(jnp.asarray(mv["rows"], jnp.int32)), put1(jnp.asarray(mv["cols"], jnp.int32)),
            put(vec(mv["vals"])), vec(mv["z"]))
        res[f"matvec-{k}"] = ints(got)
    mesh = sharded.make_mesh(2)
    ms = cfg["msm"]
    pts = JE.stack([JE.from_ref(jref.EdPoint(*p)) for p in ms["points"]])
    sh = NamedSharding(mesh, P("sp", None))
    q = JE.to_ref(jax.jit(functools.partial(sharded.msm_sharded, mesh, window=ms["window"]))(
        jax.tree.map(lambda a: jax.device_put(a, sh), pts),
        jax.device_put(vec(ms["scalars"]), sh)))
    res["msm-2"] = [q.X, q.Y, q.Z, q.T]
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _jax_main(*sys.argv[1:3])
