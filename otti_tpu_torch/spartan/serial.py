"""Proof serialization (port of otti_tpu/spartan/serial.py).

The same canonical JSON envelope as the JAX package: dataclasses tagged by
class name, scalars >= 2^53 as hex strings, bytes as hex.  The port's
proof classes carry the JAX classes' names and fields, so for equal proofs
both packages write byte-equal JSON and read each other's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from . import bullet, nizk, sigma, snark, spark, zknizk, zksumcheck

_CLASSES = {
    cls.__name__: cls
    for cls in (
        bullet.BulletOpeningProof,
        nizk.NIZKProof,
        zknizk.ZKNIZKProof,
        zksumcheck.ZKSumcheckProof,
        sigma.KnowledgeProof,
        sigma.EqualityProof,
        sigma.DualBaseEqualityProof,
        sigma.ProductProof,
        sigma.DotProductProof,
        snark.SNARKProof,
        spark.SparkEvalProof,
        spark.SparkSideProof,
    )
}


def _enc(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__type__": type(obj).__name__,
            **{f.name: _enc(getattr(obj, f.name)) for f in dataclasses.fields(obj)},
        }
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if isinstance(obj, int) and abs(obj) >= 1 << 53:
        return {"__int__": hex(obj)}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    return obj


def _dec(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__bytes__" in obj:
            return bytes.fromhex(obj["__bytes__"])
        if "__int__" in obj:
            return int(obj["__int__"], 16)
        if "__type__" in obj:
            cls = _CLASSES[obj["__type__"]]
            kwargs = {k: _dec(v) for k, v in obj.items() if k != "__type__"}
            for f in dataclasses.fields(cls):
                if f.name in kwargs and f.type == "tuple" and isinstance(kwargs[f.name], list):
                    kwargs[f.name] = tuple(kwargs[f.name])
            return cls(**kwargs)
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def dumps(proof) -> str:
    return json.dumps(_enc(proof))


def loads(data: str):
    return _dec(json.loads(data))


def save(proof, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(proof))


def load(path: str):
    with open(path) as f:
        return loads(f.read())
