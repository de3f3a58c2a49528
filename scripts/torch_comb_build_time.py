"""Time the port's comb-table build and batched inversion on one GPU.

    python3 scripts/torch_comb_build_time.py [CHECKOUT]

Builds the 128-generator ``gens_pc`` table of ``otti_tpu_torch`` three times
(the first call also pays CUDA start-up) and inverts 2^20 BASE elements
three times, printing wall seconds.  CHECKOUT (default: this repository) is
the root of the tree whose ``otti_tpu_torch`` is imported, so that two
commits can be compared in one call on one card: unpack the other commit
with ``git archive`` and run the script once for each, in turns.
"""

import os
import sys
import time

import torch

root = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, root)

from otti_tpu_torch import _build  # noqa: E402
from otti_tpu_torch.curve import edwards as E  # noqa: E402
from otti_tpu_torch.field import ops as F  # noqa: E402
from otti_tpu_torch.msm import pippenger  # noqa: E402
from otti_tpu_torch.spartan.commitments import gen_points_host  # noqa: E402


def timed(label, fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    print(root, label, round(time.time() - t0, 4), flush=True)
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.library()
    gens, _ = gen_points_host(128, b"gens_pc")
    for _ in range(3):
        table = timed("build of 128 generators, s", lambda: pippenger.build_comb_table(list(gens), "cuda"))
    x = F.unpack_words(table[:, :8].contiguous())
    for _ in range(3):
        timed("batch_inv of 2^20 elements, s", lambda: E.batch_inv(x))
