"""Carry the JAX package's state into the port's tensors.

The arguments are the JAX package's arrays as numpy (``np.asarray`` of a
jax array), so this module needs no jax itself.  With it a test feeds both
packages the same state: limb arrays, an R1CS already on the JAX device,
a comb table built by ``otti_tpu.msm.pippenger.fixed_base_tables``, or a
SPARK commitment made by ``otti_tpu.spartan.spark.commit``.
"""

from __future__ import annotations

import numpy as np
import torch

from .spartan.r1cs import R1CSDevice
from .spartan.spark import SparkCommitment


def limbs(arr, device="cpu") -> torch.Tensor:
    """JAX limb array [..., 22] int32 -> torch int32 tensor."""
    return torch.tensor(np.asarray(arr, dtype=np.int32)).to(device)


def r1cs_device(num_cons: int, num_z: int, num_vars: int, num_inputs: int,
                mats, digest: bytes, device="cpu") -> R1CSDevice:
    """The fields of a JAX ``R1CSDevice`` (mats as numpy (rows, cols, vals)
    triples; zero-padding entries are harmless) -> the port's R1CSDevice."""
    packed = tuple(
        (
            torch.from_numpy(np.asarray(r, dtype=np.int64)).to(device),
            torch.from_numpy(np.asarray(c, dtype=np.int64)).to(device),
            limbs(v, device),
        )
        for r, c, v in mats
    )
    return R1CSDevice(num_cons=num_cons, num_z=num_z, num_vars=num_vars,
                      num_inputs=num_inputs, mats=packed, digest=digest)


def comb_table(p, device="cpu") -> dict:
    """JAX packed comb table ``tbl["p"]`` ([T, 16] uint32) -> the port's
    table dict (the same bits as int32)."""
    arr = np.ascontiguousarray(np.asarray(p, dtype=np.uint32)).view(np.int32)
    return {"p": torch.from_numpy(arr.copy()).to(device)}


def spark_commitment(mu_n: int, comm_row: list, comm_col: list, comm_val: list, mu_x: int,
                     mu_y: int, row_idx, col_idx, row_f, col_f, val,
                     device="cpu") -> SparkCommitment:
    """The fields of a JAX ``SparkCommitment`` (its arrays as numpy) -> the
    port's, with the prover-retained tables on ``device``."""
    return SparkCommitment(
        mu_n=mu_n, comm_row=list(comm_row), comm_col=list(comm_col), comm_val=list(comm_val),
        mu_x=mu_x, mu_y=mu_y,
        row_idx=np.asarray(row_idx, dtype=np.int32), col_idx=np.asarray(col_idx, dtype=np.int32),
        row_f=limbs(row_f, device), col_f=limbs(col_f, device), val=limbs(val, device),
    )
