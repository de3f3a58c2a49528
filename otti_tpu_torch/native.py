# copied from otti_tpu/native.py; builds its own library under otti_tpu_torch/build/
"""ctypes binding for the native host runtime (native/otti_host.cpp).

Builds the shared library on first use (g++, a few seconds, with the flags
of native/Makefile) into ``otti_tpu_torch/build/``, keyed by a hash of the
source, and exposes:
  * keccak_f1600 / Strobe128 fast paths (transcript hot loop),
  * host scalar-field ops,
  * host edwards/ristretto ops + Pippenger MSM (verifier-side MSMs,
    sigma-protocol group math).

Every entry point has a pure-Python fallback (refimpl/, transcript/), so
the package works without a compiler; the native path is ~50x faster
for the verifier.  HAVE_NATIVE tells callers which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
_CPP = os.path.join(_PKG, "..", "native", "otti_host.cpp")
_BUILD_DIR = os.path.join(_PKG, "build")
# CXXFLAGS of native/Makefile
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-march=native", "-Wall"]

_lib = None


def _so_path() -> str:
    h = hashlib.sha256()
    with open(_CPP, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libotti_host-{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-shared", "-o", tmp, _CPP],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        so = _so_path()
    except OSError:
        return None
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.otti_init()
    lib.otti_strobe_size.restype = ctypes.c_size_t
    _lib = lib
    return lib


try:
    _load()
except Exception:  # pragma: no cover
    _lib = None

HAVE_NATIVE = _lib is not None


def keccak_f1600(state: bytearray) -> None:
    buf = (ctypes.c_uint8 * 200).from_buffer(state)
    _lib.otti_keccak_f1600(buf)


class NativeStrobe:
    """Drop-in replacement for transcript.merlin.Strobe128."""

    def __init__(self, protocol_label: bytes):
        self._buf = ctypes.create_string_buffer(int(_lib.otti_strobe_size()))
        _lib.otti_strobe_init(self._buf, protocol_label, len(protocol_label))

    def meta_ad(self, data: bytes, more: bool):
        _lib.otti_strobe_meta_ad(self._buf, data, len(data), int(more))

    def ad(self, data: bytes, more: bool):
        _lib.otti_strobe_ad(self._buf, data, len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        _lib.otti_strobe_prf(self._buf, out, n, int(more))
        return out.raw

    def key(self, data: bytes, more: bool):
        _lib.otti_strobe_key(self._buf, data, len(data), int(more))


# ---------------------------------------------------------------------------
# host curve ops over 128-byte extended-coordinate encodings
# ---------------------------------------------------------------------------

def _pt_to_bytes(p) -> bytes:
    return b"".join(v.to_bytes(32, "little") for v in (p.X, p.Y, p.Z, p.T))


def _pt_from_bytes(b: bytes):
    from .refimpl import numeric as ref

    X, Y, Z, T = (int.from_bytes(b[i * 32 : (i + 1) * 32], "little") for i in range(4))
    return ref.EdPoint(X, Y, Z, T)


def msm_host(points, scalars) -> "ref.EdPoint":
    """sum_i scalars[i] * points[i] over host EdPoints (native Pippenger)."""
    from .refimpl import numeric as ref

    n = len(points)
    if n == 0:
        return ref.EdPoint.identity()
    if not HAVE_NATIVE:
        acc = ref.EdPoint.identity()
        for k, p in zip(scalars, points):
            if k % ref.L:
                acc = acc + p * (k % ref.L)
        return acc
    pts = b"".join(_pt_to_bytes(p) for p in points)
    scs = b"".join((k % ref.L).to_bytes(32, "little") for k in scalars)
    out = ctypes.create_string_buffer(128)
    _lib.otti_msm(out, pts, scs, n)
    return _pt_from_bytes(out.raw)


def fold_pairs_host(A, B, sa: int, sb: int) -> list:
    """[sa*A[i] + sb*B[i] for i] with SHARED scalars (one library call).

    The bullet argument's per-round generator fold; falls back to n
    2-point MSMs without the native library."""
    from .refimpl import numeric as ref

    n = len(A)
    if len(B) != n:
        raise ValueError("fold_pairs_host: length mismatch")
    if not HAVE_NATIVE:
        return [msm_host([a, b], [sa, sb]) for a, b in zip(A, B)]
    a_b = b"".join(_pt_to_bytes(p) for p in A)
    b_b = b"".join(_pt_to_bytes(p) for p in B)
    out = ctypes.create_string_buffer(128 * n)
    _lib.otti_fold_pairs(
        out, a_b, b_b,
        (sa % ref.L).to_bytes(32, "little"),
        (sb % ref.L).to_bytes(32, "little"), n,
    )
    return [_pt_from_bytes(out.raw[128 * i : 128 * (i + 1)]) for i in range(n)]


def scalar_mul_host(p, k: int):
    from .refimpl import numeric as ref

    if not HAVE_NATIVE:
        return p * k
    out = ctypes.create_string_buffer(128)
    _lib.otti_pt_scalar_mul(out, _pt_to_bytes(p), (k % ref.L).to_bytes(32, "little"))
    return _pt_from_bytes(out.raw)


def ristretto_encode_host(p) -> bytes:
    if not HAVE_NATIVE:
        return p.ristretto_encode()
    out = ctypes.create_string_buffer(32)
    _lib.otti_ristretto_encode(out, _pt_to_bytes(p))
    return out.raw


def ristretto_decode_host(b: bytes):
    from .refimpl import numeric as ref

    if not HAVE_NATIVE:
        return ref.EdPoint.ristretto_decode(b)
    out = ctypes.create_string_buffer(128)
    ok = _lib.otti_ristretto_decode(out, bytes(b))
    return _pt_from_bytes(out.raw) if ok else None
