"""The SDP configuration's path through the port, at a toy size on the CPU.

An SDP made from a seed by ``proofbench/sdpgen.py`` (blocks 3 and 2, m = 4:
11,127 constraints) is written as SDPA sparse and lowered by
``cli.lower_sdp``, the program's own SDP lowering: its R1CS must equal the
benchmark's plain reference (``proofbench/reference/sdp_lowering.py``)
entry for entry, digest included; the program's witness satisfies it and a
witness off by one in one variable does not; the oracle's optimum is the
planted b.y*; the four ``sdp_*`` spans are counted.  ``run_sdp`` proves and
verifies through ``lower_sdp`` the smallest such SDP (one block of 2, m = 1:
1,886 constraints, transparent, so that the file stays within 15 s).  No
jax is imported here.
"""

import numpy as np
import pytest
import torch

from otti_tpu_torch import cli, metrics
from proofbench import sdpgen
from proofbench.reference import sdp_lowering

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

TOY = (4, [3, 2])


def _lowered(tmp_path, seed, m=TOY[0], blocks=TOY[1]):
    sdp = sdpgen.make_sdp(m, blocks, seed)
    path = str(tmp_path / f"toy{seed}.dat-s")
    sdpgen.write_dats(path, f"toy{seed}", blocks, sdp.C, sdp.A, sdp.b)
    return sdp, path, cli.lower_sdp(path)


@pytest.mark.parametrize("case, seed", [
    ("lowering", 0), ("lowering", 2**31 + 7),
    ("witness", 0), ("witness", 2**31 + 7),
    ("optimum", 0), ("optimum", 2**31 + 7),
    ("spans", 0), ("run_sdp", 3),
])
def test_sdp_config_path(tmp_path, case, seed):
    if case == "run_sdp":
        _, path, _ = _lowered(tmp_path, seed, m=1, blocks=[2])
        assert cli.run_sdp([path], str(tmp_path / "out"), zk=False, device="cpu")
        return
    metrics.reset()
    sdp, path, (shape, witness, inputs, timer) = _lowered(tmp_path, seed)
    ref = sdp_lowering.lower(sdp.C, sdp.A, sdp.b)
    if case == "lowering":
        assert (shape.num_cons, shape.num_vars, shape.num_inputs) == (11127, 11076, 0)
        assert (ref.num_cons, ref.num_vars, ref.num_inputs) == (11127, 11076, 0)
        for m, mat in enumerate((shape.A, shape.B, shape.C)):
            assert sorted(mat) == ref.entries(m)
        assert ref.digest() == shape.digest()
    elif case == "witness":
        assert ref.unsatisfied(witness, inputs) == 0
        j = int(np.random.default_rng(seed).integers(len(witness)))
        bad = witness[:j] + [witness[j] + 1] + witness[j + 1:]
        assert ref.unsatisfied(bad, inputs) > 0
    elif case == "optimum":
        from otti_tpu_torch.io import sdpa
        from otti_tpu_torch.oracle import sdp_oracle

        prob = sdpa.parse_dats(path)
        assert np.array_equal(prob.C, sdp.C) and np.array_equal(prob.b, sdp.b)
        _, y, _ = sdp_oracle.solve(prob)
        planted = float(sdp.b @ sdp.y)
        assert abs(float(sdp.b @ y) - planted) <= 1e-6 * max(1.0, abs(planted))
    else:
        spans = metrics.snapshot()
        assert {"sdp_parse_s", "sdp_oracle_s", "sdp_cholesky_s", "sdp_lower_s"} <= set(spans)
        assert set(timer.t) == {"parse", "oracle", "lower"}
        assert spans["sdp_lower_s"] + spans["sdp_cholesky_s"] <= timer.t["lower"]
