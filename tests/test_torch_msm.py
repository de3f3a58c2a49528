"""The port's variable-base MSM (msm/pippenger.py::msm and its bit-serial
forms) against the host library's Pippenger (``native.msm_host``) and
against the JAX package's ``pippenger.msm``.

Inputs are made from a seed with numpy: points k * B for random k, and
random scalars.  Every case is held against ``native.msm_host``: sizes 1, 2,
16 (the single-level scan), 32, 64 and 256 (the two-level scan) with windows
2 and 4, the edge scalars 0, 1 and l - 1, and the sizes 96, 112 and 176,
whose chunk counts (6, 7, 11) are no powers of two.  There the JAX level-2
scan runs one step too few (``max(1, m.bit_length() - 1)``) and its sums
lose a carry, so JAX is no reference at those sizes.  The JAX ``msm`` is
compiled once a shape (20-30 s on the CPU), so it is held at two: size 16
(window 2, the single-level scan, also with the edge scalars) and 64
(window 4, the two-level scan).  It
runs in a fresh interpreter (this file's ``__main__``), started when the
module starts, so that its compiles overlap the port's cases.  The point
results are compared as group elements.  Here the port runs on the CPU (the
multiply's plain version).  Tolerance: exact equality.
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
from otti_tpu_torch.msm import pippenger as P
from otti_tpu_torch.refimpl import numeric as ref

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CASES = [(n, w) for n in (1, 2, 16, 32, 64, 256) for w in (2, 4)]
JAX_CASES = [(16, 2), (64, 4)]
EDGES = [0, 1, ref.L - 1]


def _case(n: int, seed: int, edges: bool = False) -> tuple:
    """(host points, scalars): n points k_i * B and n scalars from ``seed``;
    with ``edges`` the scalars cycle through 0, 1 and l - 1 among random ones."""
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(2 * n)]
    pts = [native.scalar_mul_host(ref.EdPoint.base(), k or 1) for k in ks[:n]]
    scalars = ks[n:]
    if edges:
        scalars = [EDGES[i % 3] if i % 2 == 0 else s for i, s in enumerate(scalars)]
    return pts, scalars


def _dev(pts: list, scalars: list) -> tuple:
    return E.stack([E.from_ref(p) for p in pts]), F.from_ints(SCALAR, scalars)


def _key(n: int, w: int, edges: bool = False) -> str:
    return f"{n}-{w}{'-edges' if edges else ''}"


def _jax_inputs() -> dict:
    cases = [(n, w, False) for n, w in JAX_CASES] + [(16, 2, True)]
    return {_key(n, w, e): {"window": w, "points": [[p.X, p.Y, p.Z, p.T] for p in pts],
                            "scalars": sc}
            for n, w, e in cases for pts, sc in [_case(n, n + w, e)]}


class _JaxRef:
    """The JAX results, computed by a child interpreter started at once."""

    def __init__(self, tmp):
        self.inp, self.out = tmp / "in.json", tmp / "out.json"
        self.inp.write_text(json.dumps(_jax_inputs()))
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(self.inp),
                                      str(self.out)], cwd=REPO, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.got = None

    def __getitem__(self, key: str) -> ref.EdPoint:
        if self.got is None:
            try:
                _, err = self.proc.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                raise
            assert self.proc.returncode == 0, err[-3000:]
            self.got = json.loads(self.out.read_text())
        return ref.EdPoint(*self.got[key])

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    ref_ = _JaxRef(tmp_path_factory.mktemp("jax_msm"))
    yield ref_
    ref_.close()


@pytest.mark.parametrize("n,w", HOST_CASES)
def test_msm_matches_the_host_library(n, w):
    pts, sc = _case(n, n + w)
    assert E.to_ref(P.msm(*_dev(pts, sc), window=w)) == native.msm_host(pts, sc)


# n / 16 chunks of 6, 7 and 11: the JAX module's level-2 scan is one step
# short at these sizes (its result is wrong), so only the host library holds
# them; the port's scan runs ceil(log2 m) steps
@pytest.mark.parametrize("n", [96, 112, 176])
def test_msm_level2_scan_at_chunk_counts_no_power_of_two(n):
    pts, sc = _case(n, n)
    assert E.to_ref(P.msm(*_dev(pts, sc))) == native.msm_host(pts, sc)


def test_msm_edge_scalars_and_window_groups():
    """0, 1 and l - 1 among random scalars; the same sum with one window a
    group (the padding at the MSB end) and with all windows in one group."""
    pts, sc = _case(16, 18, edges=True)
    want = native.msm_host(pts, sc)
    for win_group in (None, 1, 127):
        assert E.to_ref(P.msm(*_dev(pts, sc), window=2, win_group=win_group)) == want


def test_msm_bitserial_and_shared_bases():
    pts, sc = _case(4, 4)
    pts_d, sc_d = _dev(pts, sc)
    assert E.to_ref(P.msm_bitserial(pts_d, sc_d)) == native.msm_host(pts, sc)
    rows = [sc, [(s * 3 + 1) % ref.L for s in sc]]
    got = P.msm_shared_bases(pts_d, torch.stack([F.from_ints(SCALAR, r) for r in rows]))
    assert E.to_refs(got) == [native.msm_host(pts, r) for r in rows]


def test_two_level_scan_against_a_naive_bucket_sum():
    """Bucket sums of 64 sorted points (4 chunks, digits of 4 bits) against
    the sums of each digit's points on the host, and the whole MSM at that window."""
    rng = np.random.default_rng(17)
    n, w = 64, 4
    pts, _ = _case(n, 17)
    digs = sorted(int(d) for d in rng.integers(0, 1 << w, n))
    want = [ref.EdPoint.identity() for _ in range(1 << w)]
    for d, p in zip(digs, pts):
        want[d] = want[d] + p
    got = P._segment_scan_bucket_sums(_dev(pts, [0] * n)[0], torch.tensor(digs), w)
    assert E.to_refs(got) == want
    sc = [int(d) for d in rng.integers(0, 1 << 62, n)]
    assert E.to_ref(P.msm(*_dev(pts, sc), w)) == native.msm_host(pts, sc)


@pytest.mark.parametrize("n,w", JAX_CASES)
def test_msm_matches_jax(jax_ref, n, w):
    pts, sc = _case(n, n + w)
    assert E.to_ref(P.msm(*_dev(pts, sc), window=w)) == jax_ref[_key(n, w)]


def test_msm_edge_scalars_match_jax(jax_ref):
    pts, sc = _case(16, 18, edges=True)
    assert E.to_ref(P.msm(*_dev(pts, sc), window=2)) == jax_ref[_key(16, 2, True)]


@pytest.mark.cuda
def test_msm_on_the_card_matches_the_host_library():
    """The bucket scan's adds through kernel 1 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n in (96, 1024):
        pts, sc = _case(n, n)
        pts_d, sc_d = _dev(pts, sc)
        got = P.msm(E.tree_map(lambda a: a.cuda(), pts_d), sc_d.cuda())
        assert E.to_ref(got) == native.msm_host(pts, sc)


def _jax_main(inp: str, out: str) -> None:
    """Child interpreter: the JAX package's msm on every case of ``inp``."""
    import functools

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from otti_tpu.curve import edwards as JE
    from otti_tpu.field import fields as JF
    from otti_tpu.msm import pippenger as JP
    from otti_tpu.refimpl import numeric as jref
    from otti_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    jitted = {}
    res = {}
    for key, case in json.loads(open(inp).read()).items():
        w = case["window"]
        fn = jitted.setdefault(w, jax.jit(functools.partial(JP.msm, window=w)))
        pts = JE.stack([JE.from_ref(jref.EdPoint(*p)) for p in case["points"]])
        q = JE.to_ref(fn(pts, jnp.asarray(JF.ints_to_limbs(case["scalars"]))))
        res[key] = [q.X, q.Y, q.Z, q.T]
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _jax_main(*sys.argv[1:3])
