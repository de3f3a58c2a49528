"""The SNARK modules of the port in an interpreter without jax.

A file of its own: its one case starts a fresh interpreter (this one
imported jax through conftest) and shares nothing with the cases that hold
the port against the JAX package.  There every SNARK module is imported, a
small R1CS is committed, proved and verified on the CPU, the proof goes
through ``serial`` and back, and neither jax nor the JAX package may have
been imported by the end.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_snark_modules_run_without_jax():
    """In a fresh interpreter (this one imported jax through conftest)."""
    code = (
        "import sys\n"
        "from otti_tpu_torch.spartan import hyrax, r1cs, serial, snark, spark, sumcheck\n"
        "from otti_tpu_torch.io import mps, sdpa, zkif\n"
        "from otti_tpu_torch.oracle import lp_oracle, sdp_infeas, sdp_oracle\n"
        "from otti_tpu_torch.codegen import lp_cert, sdp_cert\n"
        "from otti_tpu_torch import cli, convert\n"
        "shape, zvars = r1cs.random_satisfiable(4, 4)\n"
        "dev = shape.to_device('cpu')\n"
        "comm = spark.commit(dev)\n"
        "proof = snark.prove(dev, comm, zvars, [])\n"
        "assert snark.verify(dev, comm, [], proof)\n"
        "assert serial.loads(serial.dumps(proof)) == proof\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "strays = [m for m in sys.modules if m == 'otti_tpu' or m.startswith('otti_tpu.')]\n"
        "assert not strays, strays\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
