"""The LP, SDP and zkinterface paths of the port in an interpreter without jax.

A file of its own: its one case starts a fresh interpreter (this one
imported jax through conftest) and shares nothing with the proving cases of
tests/test_torch_lp_sdp.py.  There an LP and an SDP written from a seed are
parsed, solved and lowered through the port's command line on the CPU, a
lowered instance goes through a zkinterface triple and back, and neither
jax nor the JAX package may have been imported by the end.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lp_sdp_zkif_paths_run_without_jax(tmp_path):
    code = (
        "import os, sys\n"
        "import chip_smoke\n"
        "from otti_tpu_torch import cli\n"
        "from otti_tpu_torch.codegen import lp_cert\n"
        "from otti_tpu_torch.io import mps, sdpa, zkif\n"
        "from otti_tpu_torch.oracle import lp_oracle\n"
        "tmp = sys.argv[1]\n"
        "lp, sdp = os.path.join(tmp, 'gen3x4.mps'), os.path.join(tmp, 'rand1x1.dat-s')\n"
        "chip_smoke.write_lp_mps(lp, 3, 4, seed=1)\n"
        "chip_smoke.write_sdp_dats(sdp, sdpa.random_problem(1, 1, seed=1)[0])\n"
        "for flags in (['--lp', '--custom', lp], ['--sdp', '--custom', sdp]):\n"
        "    assert cli.main(flags + ['--no-prove', '--device', 'cpu', '--out', tmp]) == 0\n"
        "prob = mps.parse_mps(lp)\n"
        "x, y, _ = lp_oracle.solve(prob)\n"
        "shape, vars_, inputs = lp_cert.build(prob, x, y)\n"
        "assert shape.is_satisfied(vars_, inputs)\n"
        "base = os.path.join(tmp, 'lp')\n"
        "zkif.export_r1cs(shape, vars_, inputs, base)\n"
        "back, vars_b, inputs_b = zkif.import_r1cs(base + '.zkif', base + '.wit.zkif',\n"
        "                                          base + '.inp.zkif')\n"
        "assert (back.num_cons, vars_b, inputs_b) == (shape.num_cons, vars_, inputs)\n"
        "assert back.is_satisfied(vars_b, inputs_b)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "strays = [m for m in sys.modules if m == 'otti_tpu' or m.startswith('otti_tpu.')]\n"
        "assert not strays, strays\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "lowered gen3x4.mps" in res.stdout and "lowered rand1x1.dat-s" in res.stdout
    assert res.stdout.strip().endswith("ok")
