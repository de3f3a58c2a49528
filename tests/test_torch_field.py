"""Port field arithmetic (otti_tpu_torch.field) against otti_tpu.field.ops.

The same numpy-made inputs go through the JAX functions and the port's; the
tolerance is exact equality of canonical values (modular arithmetic).  On
the CPU the port's multiply is its plain version; the CUDA kernel is held
against that plain version in the ``cuda`` tests, which skip without a card.
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

from otti_tpu.field import ops as JF
from otti_tpu.field import pallas_kernels as PK
from otti_tpu.field.fields import (
    BASE, N_LIMBS, SCALAR, int_to_limbs, ints_to_limbs, limbs_to_int,
)
from otti_tpu_torch import _build
from otti_tpu_torch.field import fields as PF
from otti_tpu_torch.field import kernels as K
from otti_tpu_torch.field import ops as F

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

SPECS = [SCALAR, BASE]


def _inputs(spec, seed, n=48):
    """Random canonical values, edge values and non-canonical semi forms."""
    rng = np.random.default_rng(seed)
    m = spec.modulus
    vals = [int.from_bytes(rng.bytes(40), "little") % m for _ in range(n)]
    vals += [0, 1, m - 1, (1 << spec.semi_bound_bits) - 1]
    limbs = np.stack([int_to_limbs(v) for v in vals]).astype(np.int32)
    # same values, limbs moved one unit of 2^12 down (limbs > 2^12 and -1)
    semi = limbs.copy()
    for row in range(0, len(vals), 3):
        pos = int(rng.integers(1, N_LIMBS))
        semi[row, pos] -= 1
        semi[row, pos - 1] += 1 << 12
    return vals, semi


def _ints(spec, x):
    return F.to_ints(spec, torch.from_numpy(np.array(x)))


@pytest.fixture(scope="module")
def jitted():
    return {
        (spec.name, op): jax.jit(lambda a, b, s=spec, f=fn: JF.canon(s, f(s, a, b)))
        for spec in SPECS
        for op, fn in (("mul", JF.mul), ("add", JF.add), ("sub", JF.sub))
    }


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_binary_ops_match_jax(spec, op, jitted):
    _, a = _inputs(spec, 1)
    _, b = _inputs(spec, 2)
    want = _ints(spec, jitted[(spec.name, op)](jnp.asarray(a), jnp.asarray(b)))
    got = F.to_ints(spec, getattr(F, op)(spec, torch.from_numpy(a), torch.from_numpy(b)))
    assert got == want


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_canon_neg_mul_small_match_jax(spec):
    vals, a = _inputs(spec, 3)
    ta = torch.from_numpy(a)
    canon = F.canon(spec, ta)
    assert canon.dtype == torch.int32
    assert np.array_equal(canon.numpy(), np.asarray(jax.jit(lambda x: JF.canon(spec, x))(a)))
    canonical = F.from_ints(spec, vals)  # neg takes values below 2m
    assert F.to_ints(spec, F.neg(spec, canonical)) == [(-v) % spec.modulus for v in vals]
    assert F.to_ints(spec, F.mul_small(spec, ta, 12345)) == [v * 12345 % spec.modulus for v in vals]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_dot_and_sum_reduce_match_jax(spec):
    _, a = _inputs(spec, 4)
    _, b = _inputs(spec, 5)
    want_dot = _ints(spec, jax.jit(lambda x, y: JF.canon(spec, JF.dot(spec, x, y)))(a, b))
    want_sum = _ints(spec, jax.jit(lambda x: JF.canon(spec, JF.sum_reduce(spec, x)))(a))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert F.to_ints(spec, F.dot(spec, ta, tb)) == want_dot
    assert F.to_ints(spec, F.sum_reduce(spec, ta)) == want_sum


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mul_matches_pallas_interpret(spec):
    """The port's multiply against the TPU kernel it replaces, run in the
    Pallas interpreter on the CPU."""
    _, a = _inputs(spec, 6, n=12)
    _, b = _inputs(spec, 7, n=12)
    want = _ints(spec, PK.mul_pallas(spec, jnp.asarray(a), jnp.asarray(b), interpret=True))
    assert F.to_ints(spec, K.mul_plain(spec, torch.from_numpy(a), torch.from_numpy(b))) == want


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mul_broadcast_operand(spec):
    """The shared-scalar shape (the JAX package's mul_scalar) is the same
    multiply with one operand broadcast."""
    vals, a = _inputs(spec, 8)
    r = 0x1234567890ABCDEF1234567890ABCDEF
    got = F.mul(spec, torch.from_numpy(a), F.const(spec, r))
    assert F.to_ints(spec, got) == [v * r % spec.modulus for v in vals]
    want = _ints(spec, jax.jit(lambda x: JF.canon(spec, JF.mul_scalar(
        spec, x, jnp.asarray(int_to_limbs(r)))))(np.tile(a, (12, 1))))
    assert F.to_ints(spec, F.mul(spec, torch.from_numpy(np.tile(a, (12, 1))),
                                 F.const(spec, r))) == want


def test_pack_words_match_jax():
    vals, _ = _inputs(BASE, 9)
    canon = ints_to_limbs([v % BASE.modulus for v in vals])
    want = np.asarray(jax.jit(JF.pack_words)(canon))
    words = F.pack_words(torch.from_numpy(canon))
    assert np.array_equal(F.words_to_i32(words).numpy().view(np.uint32), want)
    assert np.array_equal(F.unpack_words(F.words_to_i32(words)).numpy(), canon)


def test_host_codecs_roundtrip():
    vals, _ = _inputs(SCALAR, 10)
    t = F.from_ints(SCALAR, vals)
    assert t.shape == (len(vals), N_LIMBS) and t.dtype == torch.int32
    assert F.to_ints(SCALAR, t) == [v % SCALAR.modulus for v in vals]
    assert F.from_ints(SCALAR, []).shape == (0, N_LIMBS)


def _value(words):
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def test_kernel_constants_match_field_specs():
    """The block copied into the kernels' constant memory holds, per field,
    the 8 words of the modulus, the 4 words of the tail (c, or 19) and
    2^256 mod p: checked against the port's own field specs (their source)
    and against the JAX package's."""
    c = _build.field_consts()
    assert c.dtype == np.int32 and c.shape == (2 * _build.CONST_WORDS,)
    blocks = c.view(np.uint32).reshape(2, _build.CONST_WORDS)
    for blk, spec in list(zip(blocks, SPECS)) + list(zip(blocks, [PF.SCALAR, PF.BASE])):
        assert _value(blk[:8]) == spec.modulus
        assert _value(blk[8:12]) == spec.tail
        # the folds the kernel relies on
        if spec.kind == "scalar":
            assert (1 << 252) % spec.modulus == spec.modulus - _value(blk[8:12])
            assert blk[12] == 0
        else:
            assert (1 << 255) % spec.modulus == _value(blk[8:12]) == 19
            assert (1 << 256) % spec.modulus == int(blk[12]) == 38
    assert K.FIELD_IDS == {"scalar": 0, "base": 1}  # the order of the blocks


def _edge_pairs(spec, seed, n_random):
    """(a, b) integer pairs below 2^256: the edges of the kernel's contract
    and seeded random values, with their semi-form limb rows."""
    rng = np.random.default_rng(seed)
    m = spec.modulus
    top = (1 << spec.semi_bound_bits) - 1
    edges = [0, 1, m - 1, m, top, (1 << 252) - 1, 1 << 252, (1 << 255) - 19,
             1 << 255, (1 << 256) - 39, (1 << 256) - 38, (1 << 256) - 1]
    pairs = [(a, b) for a in edges for b in edges]
    pairs += [(int.from_bytes(rng.bytes(32), "little"), int.from_bytes(rng.bytes(32), "little"))
              for _ in range(n_random)]

    def semi(v):
        x = int_to_limbs(v).astype(np.int64)
        for _ in range(4):  # limbs above 2^12, and -1 where a limb was 0
            pos = int(rng.integers(1, N_LIMBS))
            if rng.random() < 0.5:
                x[pos] -= 1
                x[pos - 1] += 1 << 12
        return x

    a = np.stack([semi(a) for a, _ in pairs]).astype(np.int32)
    b = np.stack([semi(b) for _, b in pairs]).astype(np.int32)
    return pairs, a, b


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_word_model_matches_python_integers(spec):
    """The Python model of the kernel's word arithmetic (pack, 8x8 product,
    both reductions, unpack) against ``%`` on the contract's edges and a
    few hundred seeded values; the model asserts every intermediate range
    the CUDA code relies on."""
    pairs, a, b = _edge_pairs(spec, 21, 300)
    assert (a == -1).any() and (a > 4095).any()
    for (x, y), ra, rb in zip(pairs, a.tolist(), b.tolist()):
        got = K.mul_words_model(spec, ra, rb)
        assert all(0 <= v < 4096 for v in got)
        assert limbs_to_int(got) == x * y % spec.modulus, (x, y)
    with pytest.raises(AssertionError):  # 2^256 is outside the contract
        K.mul_words_model(spec, [0] * 21 + [1 << 4], [1] + [0] * 21)


@pytest.fixture(scope="module")
def host_arith(tmp_path_factory):
    """csrc/field.cuh compiled for the host (csrc/host_check.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("host_arith") / "libotti_field_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    os.path.join(_build.CSRC_DIR, "host_check.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    consts = _build.field_consts()
    lib.otti_host_set_consts(consts.ctypes.data_as(ctypes.c_void_p))
    return lib


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_device_arithmetic_on_host_matches_plain(spec, host_arith):
    """The very C++ the kernels run (fe_pack, fe_mul, fe_canon, fe_add,
    fe_sub, fe_unpack), compiled for the host, against Python integers and
    against the plain torch multiply."""
    pairs, a, b = _edge_pairs(spec, 22, 2000)
    m, fid = spec.modulus, K.FIELD_IDS[spec.kind]
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    out = np.zeros_like(a)
    host_arith.otti_host_mul(ptr(a), ptr(b), ptr(out), ctypes.c_longlong(len(pairs)), fid)
    assert [limbs_to_int(r) for r in out] == [x * y % m for x, y in pairs]
    assert out.min() >= 0 and out.max() < 4096
    assert np.array_equal(out, K.mul_plain(spec, torch.from_numpy(a), torch.from_numpy(b)).numpy())
    for op, fn in ((0, lambda x, y: x % m), (1, lambda x, y: (x + y) % m),
                   (2, lambda x, y: (x - y) % m)):
        host_arith.otti_host_addsub(ptr(a), ptr(b), ptr(out),
                                    ctypes.c_longlong(len(pairs)), fid, op)
        assert [limbs_to_int(r) for r in out] == [fn(x, y) for x, y in pairs]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on CPU tensors (that is mul_plain's
    job, chosen by ``mul`` from the device)."""
    a = F.from_ints(SCALAR, [3, 4])
    with pytest.raises(ValueError):
        K.mul_cuda(SCALAR, a, a)
    assert _build.LAUNCHES["field_mul"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_mul_kernel_matches_plain_on_card(spec, cuda_device):
    _, a = _inputs(spec, 11, n=4096)
    _, b = _inputs(spec, 12, n=4096)
    ta, tb = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    before = _build.LAUNCHES["field_mul"]
    got = K.mul_cuda(spec, ta, tb)
    assert _build.LAUNCHES["field_mul"] == before + 1
    assert torch.equal(got, K.mul_plain(spec, ta, tb))
    s = ta[5].contiguous()
    assert torch.equal(K.mul_cuda(spec, tb, s), K.mul_plain(spec, tb, s))
