"""The port's ristretto encoding (kernel K4's plain version) and its
variable-base Edwards ops against the JAX package and the host library.

Points made from a numpy seed (generator multiples, the identity, device
sums with general Z and T, semi-form limbs) go through
``otti_tpu.curve.ristretto.encode`` (jitted), the port's
``ristretto.encode`` (on the CPU: ``encode_plain``), the host library's
``ristretto_encode_host``, and ``csrc/ristretto.cuh`` compiled for the host
(the very C++ the kernel runs); every encoding must be equal byte for byte.
That header's loose multiply and dedicated square are held against Python
integers on the edges of their input range.
``edwards.scalar_mul`` is held against the JAX package's ``E.scalar_mul``
and the host.  Tolerance: exact equality.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.curve import edwards as JE
from otti_tpu.curve import ristretto as JR
from otti_tpu.field.fields import BASE, SCALAR, ints_to_limbs
from otti_tpu_torch import _build, native
from otti_tpu_torch.curve import edwards as E
from otti_tpu_torch.curve import ristretto as R
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.refimpl import numeric as ref

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each


@pytest.fixture(scope="module")
def points():
    """12 points: the identity, base-point multiples, their device sums
    (general Z and T) and doubles, as one [12] batch and as host points."""
    rng = np.random.default_rng(11)
    ks = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(4)]
    host = [ref.EdPoint.identity()] + [ref.EdPoint.base() * k for k in ks + [1, ref.L - 1]]
    a = E.stack([E.from_ref(q) for q in host[1:4]])
    b = E.stack([E.from_ref(q) for q in host[4:7]])
    sums, dbls = E.add(a, b), E.double(a)
    host += [p + q for p, q in zip(host[1:4], host[4:7])] + [p + p for p in host[1:3]]
    batch = E.tree_map(lambda *xs: torch.cat(xs), E.stack([E.from_ref(q) for q in host[:7]]),
                       sums, E.tree_map(lambda x: x[:2], dbls))
    # the same values with non-canonical limbs (one unit of 2^12 moved down a limb)
    batch["y"] = batch["y"].clone()
    batch["y"][:, 5] -= 1
    batch["y"][:, 4] += 4096
    return batch, host


@pytest.fixture(scope="module")
def jax_encodings(points):
    j_batch = {k: jnp.asarray(v.numpy()) for k, v in points[0].items()}
    return np.asarray(jax.jit(JR.encode)(j_batch))


def test_encode_matches_jax_and_host(points, jax_encodings):
    batch, host = points
    got = R.encode(batch)
    assert got.shape == (len(host), 32) and got.dtype == torch.uint8
    want_host = [native.ristretto_encode_host(q) for q in host]
    assert [bytes(r) for r in got.numpy()] == want_host
    assert want_host[0] == bytes(32)
    assert np.array_equal(jax_encodings, got.numpy())
    # one unbatched point, through the wrapper
    one = R.encode(E.tree_map(lambda x: x[3], batch))
    assert one.shape == (32,) and bytes(one.numpy()) == want_host[3]


def test_sqrt_ratio_m1_matches_refimpl():
    rng = np.random.default_rng(12)
    us = [1, 0, 2] + [int.from_bytes(rng.bytes(32), "little") % ref.P for _ in range(5)]
    vs = [1, 1, 1] + [int.from_bytes(rng.bytes(32), "little") % ref.P for _ in range(5)]
    was, r = R.sqrt_ratio_m1(F.from_ints(BASE, us), F.from_ints(BASE, vs))
    want = [ref.sqrt_ratio_m1(u, v) for u, v in zip(us, vs)]
    assert was.tolist() == [w for w, _ in want]
    assert F.to_ints(BASE, r) == [x for _, x in want]
    assert not all(was.tolist())  # a non-square is among them


@pytest.fixture(scope="module")
def host_encode(tmp_path_factory):
    """csrc/ristretto.cuh on csrc/field.cuh compiled for the host
    (csrc/host_check.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("host_encode") / "libotti_host_check.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    os.path.join(_build.CSRC_DIR, "host_check.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    consts = _build.ristretto_consts()
    lib.otti_host_set_ristretto_consts(consts.ctypes.data_as(ctypes.c_void_p))
    return lib


def test_kernel_arithmetic_on_host_matches_plain(points, host_encode, jax_encodings):
    """The per-point encoding the kernel runs, compiled for the host, on
    the semi-form rows the kernel reads: equal to the plain version, the
    JAX package's encode and the host library."""
    batch, host = points
    rows = [np.ascontiguousarray(batch[k].numpy()) for k in ("x", "y", "z", "t")]
    out = np.zeros((len(host), 32), np.uint8)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    host_encode.otti_host_ristretto_encode(*(ptr(r) for r in rows), ptr(out),
                                           ctypes.c_longlong(len(host)))
    assert [bytes(r) for r in out] == [native.ristretto_encode_host(q) for q in host]
    assert np.array_equal(out, R.encode_plain(batch).numpy())
    assert np.array_equal(out, jax_encodings)
    block = _build.ristretto_consts().view(np.uint32)
    assert block.shape == (2 * _build.CONST_WORDS + 16,)
    words = lambda w: sum(int(v) << (32 * i) for i, v in enumerate(w))  # noqa: E731
    assert words(block[26:34]) == ref.SQRT_M1 and words(block[34:]) == ref.INVSQRT_A_MINUS_D


def _words8(vals) -> np.ndarray:
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals], np.uint32)


@pytest.mark.parametrize("op", ["mul", "sq"])
def test_loose_base_arithmetic_on_host(host_encode, op):
    """ristretto.cuh's loose multiply and dedicated square (36 word
    products), compiled for the host: any input below 2^256, an output below
    2^256 congruent to the product mod p, never canonicalised.  Every pair of
    edge values (0, 1, p - 1, p, 2^255, 2^256 - 1, ...), random values, and
    the outputs fed back in twice."""
    P = ref.P
    rng = np.random.default_rng(16)
    edges = [0, 1, P - 1, P, P + 1, 1 << 255, (1 << 256) - 38, (1 << 256) - 1]
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(64)]
    xs = [a for a in edges for _ in edges] + rand
    ys = [b for _ in edges for b in edges] + rand[::-1]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    for _ in range(3):
        a, b = _words8(xs), _words8(ys if op == "mul" else xs)
        out = np.zeros_like(a)
        host_encode.otti_host_loose(ptr(a), ptr(b), ptr(out), ctypes.c_longlong(len(xs)),
                                    0 if op == "mul" else 1)
        got = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in out]
        want = [x * (y if op == "mul" else x) % P for x, y in zip(xs, ys)]
        assert all(g < 1 << 256 for g in got)
        assert [g % P for g in got] == want
        xs, ys = got, got[::-1]  # loose outputs as inputs
    assert any(g >= P for g in got)  # loose: not canonicalised


def test_scalar_mul_and_point_ops_match_jax():
    """scalar_mul (the 253-step ladder) on a device sum, against the JAX
    package's and the host's; negate, cadd and projective eq."""
    rng = np.random.default_rng(13)
    k = int.from_bytes(rng.bytes(32), "little") % ref.L
    p_host = ref.EdPoint.base() * 5 + ref.EdPoint.base() * 9
    p = E.add(E.from_ref(ref.EdPoint.base() * 5), E.from_ref(ref.EdPoint.base() * 9))
    got = E.scalar_mul(p, F.from_ints(SCALAR, [k])[0])
    assert E.to_ref(got) == p_host * k
    jp = JE.from_ref(p_host)
    want = jax.jit(JE.scalar_mul)(jp, jnp.asarray(ints_to_limbs([k]))[0])
    want_ref = ref.EdPoint(*(int(F.to_int(BASE, torch.from_numpy(np.array(want[c]))))
                             for c in ("x", "y", "z", "t")))
    assert E.to_ref(got) == want_ref
    assert bytes(R.encode(got).numpy()) == (p_host * k).ristretto_encode()
    neg = E.negate(p)
    assert E.to_ref(neg) == -p_host
    assert bool(E.eq(E.add(p, neg), E.identity((), "cpu")))
    assert not bool(E.eq(p, neg))
    mask = torch.tensor([True, False])
    two = E.stack([p, p])
    added = E.to_refs(E.cadd(mask, two, E.stack([p, p])))
    assert added == [p_host + p_host, p_host]


def test_encode_kernel_wrapper_refuses_cpu_tensors(points):
    with pytest.raises(ValueError):
        R.encode_cuda(points[0])
    assert _build.LAUNCHES["ristretto_encode"] == 0


@pytest.mark.cuda
def test_encode_kernel_matches_plain_on_card(points):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch = E.tree_map(lambda x: x.cuda(), points[0])
    before = _build.LAUNCHES["ristretto_encode"]
    got = R.encode_cuda(batch)
    assert _build.LAUNCHES["ristretto_encode"] == before + 1
    assert torch.equal(got, R.encode_plain(batch))


def test_plain_multiply_takes_the_lazy_sums():
    """Edwards add and double feed the multiply sums a + b and a - b + p of
    canonical a, b (values in [0, 2p), limbs in (-2^12, 2^13)) and
    2 (p - xy): the plain multiply's reduction must give the product of
    such rows, as the kernel does for any row below 2^256."""
    from otti_tpu.field.fields import int_to_limbs as j_limbs, limbs_to_int
    from otti_tpu_torch.field import kernels as K

    rng = np.random.default_rng(14)
    P = ref.P
    rows, vals = [], []
    for i in range(300):
        a, b = (int.from_bytes(rng.bytes(32), "little") % P for _ in range(2))
        if i < 4:
            a, b = [(0, P - 1), (P - 1, 0), (P - 1, P - 1), (0, 0)][i]
        la, lb, lp = (np.asarray(j_limbs(v), np.int64) for v in (a, b, P))
        for limbs, value in ((la + lb, a + b), (la + lp - lb, a + P - b), ((lp - lb) * 2, 2 * (P - b))):
            rows.append(limbs)
            vals.append(value)
    for i in range(0, 120, 2):  # the same values with limbs near the bound, -2^13 and 2^13
        limbs, pos = np.asarray(j_limbs(vals[i]), np.int64), 1 + i % 16
        if limbs[pos] >= 1:
            limbs[pos] -= 8192
            limbs[pos + 1] += 2
        if limbs[pos + 4] >= 1:
            limbs[pos + 4] -= 1
            limbs[pos + 3] += 4096
        rows.append(limbs)
        vals.append(vals[i])
    x = torch.from_numpy(np.stack(rows).astype(np.int32))
    assert int(x.min()) < -8000 and int(x.max()) > 8000 and int(x.abs().max()) < 8192
    y = x.flip(0)
    got = F.to_ints(BASE, K.mul_plain(BASE, x, y))
    assert got == [u * v % P for u, v in zip(vals, vals[::-1])]
    assert all(limbs_to_int(r) == v for r, v in zip(np.stack(rows), vals))
