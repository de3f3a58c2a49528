"""Build and load the hand-written CUDA kernels of ``csrc/`` at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles each ``csrc/*.cu`` into a shared library of its own with a plain C
interface under ``otti_tpu_torch/build/`` (listed in ``.gitignore``), all
compilers started together; the libraries are loaded with ``ctypes`` and
keyed by a hash of the sources, so an edited source is rebuilt.  What
``-Xptxas -v`` prints (registers, shared memory, spills) is kept beside each
library as ``<library>.log``.  A failed build or a failed launch raises.

Nothing here runs at import: the CPU tests import every module of the port,
and a machine without ``nvcc`` never reaches :func:`library`.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the kernel
on the device; the wrappers add to it at the launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES = {"field_mul": 0, "sumcheck_round": 0}

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None  # wall time of this process's build (None: cached libraries)
PTXAS_LOGS: dict = {}  # kernel source name -> what ptxas -v printed
LIB_PATHS: dict = {}  # kernel source name -> its loaded shared library

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# source file (without .cu) -> its exported functions
_SIGNATURES = {
    "field_mul": {
        "otti_field_mul_init": [_P],
        "otti_field_mul": [_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P],
    },
    "sumcheck_round": {
        "otti_sumcheck_init": [_P],
        "otti_sumcheck_round": [_P, _P, _P, _P, ctypes.c_int, _P, _LL, _LL, _P, _P, _P],
    },
}

CONST_WORDS = 13  # uint32 words of one FieldConsts: mod[8], tail[4], fold


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _words(value: int, n: int) -> list:
    assert 0 <= value < 1 << (32 * n)
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def field_consts() -> np.ndarray:
    """The FieldConsts[2] block of csrc/field.cuh (SCALAR, then BASE), from
    the field specs: the 8 words of m, the 4 words of the tail (c = l -
    2^252, or 19 = 2^255 mod p), and 2^256 mod p = 38 (0 for SCALAR, which
    does not use it).  uint32 words stored in an int32 array."""
    from .field.fields import BASE, SCALAR

    rows = []
    for spec in (SCALAR, BASE):
        fold = (1 << 256) % spec.modulus if spec.kind == "base" else 0
        rows += _words(spec.modulus, 8) + _words(spec.tail, 4) + _words(fold, 1)
    return np.array(rows, dtype=np.uint32).view(np.int32)


def _build(jobs: list) -> None:
    """jobs: (source, library path) pairs; one nvcc each, run side by side."""
    global BUILD_SECONDS
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src, path in jobs:
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((src, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, path, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed on %s (rc=%d):\n%s\n%s" % (src, proc.returncode, out, err))
            continue
        with open(path + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_SECONDS = time.time() - t0


def library() -> types.SimpleNamespace:
    """The loaded kernel functions (one attribute per exported C function),
    built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
        paths = {}
        for name in _SIGNATURES:
            h = hashlib.sha256()
            for f in [name + ".cu"] + headers:
                with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                    h.update(f.encode() + b"\0" + fh.read())
            h.update(" ".join(NVCC_FLAGS).encode())
            paths[name] = os.path.join(BUILD_DIR, f"libotti_{name}-{h.hexdigest()[:16]}.so")
        jobs = [(os.path.join(CSRC_DIR, name + ".cu"), p)
                for name, p in paths.items() if not os.path.exists(p)]
        if jobs:
            _build(jobs)
        fns = types.SimpleNamespace()
        consts = field_consts()
        for name, sigs in _SIGNATURES.items():
            lib = ctypes.CDLL(paths[name])
            for fname, args in sigs.items():
                fn = getattr(lib, fname)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                setattr(fns, fname, fn)
                if fname.endswith("_init"):  # each library owns its constants
                    check(fn(consts.ctypes.data), f"{fname} (constant upload)")
            with open(paths[name] + ".log") as f:
                PTXAS_LOGS[name] = f.read()
            LIB_PATHS[name] = paths[name]
        _lib = fns
        return fns


def ptxas_summary(log: str) -> list:
    """The register, shared-memory and spill lines of a ``ptxas -v`` log,
    each with its kernel's name in front."""
    out, fn = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error {err} in {what}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
