"""The custom sumcheck round (spartan/custom_kernels.py, kernel K5's plain
version) and the device-transcript custom sumcheck
(sumcheck.prove_custom_device) against otti_tpu.spartan.sumcheck.

At the shapes of test_torch_hyrax.py's prove_custom test (spark_table at
n = 8, spark_entry4 at n = 16): for spark_table, the first round against
``_custom_eval_kernel``, every bound round against ``_custom_step_kernel``
and the bare final bind against ``_bind_kernel`` (on the active prefix:
the JAX kernels also write rows past it); for both, the whole sumcheck
against the JAX ``prove_custom_device`` and the port's ``prove_custom``
(every round's evaluations and the final values).  The JAX round kernels
of spark_entry4 cost 36 s of cold compile and hold nothing that its whole
sumcheck does not.  Then the transcript handoff, SPARK's three call
sites, the argument checks and an interpreter without jax.  The port runs on the CPU
(plain versions of its kernels).  Tolerance: exact equality, this is
modular arithmetic.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.field import ops as JF
from otti_tpu.field.fields import SCALAR, int_to_limbs, ints_to_limbs, limbs_to_int
from otti_tpu.spartan import spark as JSP  # noqa: F401  (registers the JAX combinations)
from otti_tpu.spartan import sumcheck as JSC
from otti_tpu.transcript.merlin import Transcript as JTranscript
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.spartan import custom_kernels as CK
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import snark as TSN
from otti_tpu_torch.spartan import spark as TSP  # noqa: F401  (registers the combinations)
from otti_tpu_torch.spartan import sumcheck as TSC
from otti_tpu_torch.transcript.merlin import Transcript as TTranscript

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = SCALAR.modulus
SHAPES = [("spark_table", 3, 4, 2, 8), ("spark_entry4", 4, 9, 4, 16)]
IDS = ["spark_table", "spark_entry4"]


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % M for _ in range(n)]


def _case(key, degree, k, kc, n):
    """(table values, const values, challenges) from numpy seeds."""
    vals = [_ints(n, 300 + degree * 10 + q) for q in range(k)]
    return vals, _ints(kc, 400 + degree), _ints(n.bit_length(), 500 + degree)


def _jax_ints(x):
    arr = np.asarray(JF.canon_jit(SCALAR)(x))
    return [limbs_to_int(row) % M for row in arr.reshape(-1, arr.shape[-1])]


def _post_challenge(label=b"custom test"):
    """A port and a JAX host transcript, equal, each at the post-challenge
    offsets (a challenge vector drawn last, as at every SPARK call site)."""
    tt, tj = TTranscript(label), JTranscript(label)
    for t in (tt, tj):
        t.append_scalar(b"x", (12345).to_bytes(32, "little"))
        t.challenge_vector(b"rho", 2)
    return tt, tj


def test_round_plain_matches_jax_round_kernels():
    """Every round: the first against _custom_eval_kernel, the bound ones
    (int and tensor challenges in turn) against _custom_step_kernel, the
    bare final bind against _bind_kernel; evaluations and the active
    prefix of every table."""
    key, degree, k, kc, n = SHAPES[0]
    vals, cvals, rs = _case(key, degree, k, kc, n)
    jt = tuple(jnp.asarray(ints_to_limbs(v)) for v in vals)
    jc = tuple(jnp.asarray(ints_to_limbs([c])[0]) for c in cvals)
    stacked = torch.stack([F.from_ints(SCALAR, v) for v in vals])
    consts = F.from_ints(SCALAR, cvals)
    ev_j = JSC._custom_eval_kernel(n, key, degree, k, kc)(jnp.int32(n // 2), jc, *jt)
    ev_t = CK.custom_round_plain(stacked, consts, key, degree)
    assert ev_t.shape == (degree, 22)
    assert F.to_ints(SCALAR, ev_t) == _jax_ints(ev_j)
    active = n
    for j, r in enumerate(rs[1:]):
        rl = jnp.asarray(int_to_limbs(r))
        r_t = F.from_int(SCALAR, r) if j % 2 else r
        if active > 2:
            ev_j, jt = JSC._custom_step_kernel(n, key, degree, k, kc)(
                rl, jnp.int32(active // 2), jc, *jt)
        else:
            ev_j, jt = None, JSC._bind_kernel(n, k)(rl, jnp.int32(1), *jt)
        ev_t = CK.custom_round_plain(stacked, consts, key, degree, r_t, active // 2)
        active //= 2
        if ev_j is None:
            assert ev_t is None
        else:
            assert F.to_ints(SCALAR, ev_t) == _jax_ints(ev_j)
        for q in range(k):
            assert F.to_ints(SCALAR, stacked[q, :active]) == _jax_ints(jt[q][:active])
        if active == 1:
            break
    assert active == 1


@pytest.mark.parametrize("key,degree,k,kc,n", SHAPES, ids=IDS)
def test_prove_custom_device_matches_jax_and_host_form(key, degree, k, kc, n):
    """Rounds, challenges, final values, final claim and the host
    transcript afterwards: the same from the JAX prove_custom_device, the
    port's prove_custom_device and the port's prove_custom; the tables
    handed in are left untouched, and the replay accepts the rounds."""
    vals, cvals, _ = _case(key, degree, k, kc, n)
    tables = tuple(F.from_ints(SCALAR, v) for v in vals)
    consts = tuple(F.from_int(SCALAR, c) for c in cvals)
    comb = CK._COMB_REGISTRY[key]
    claim = F.to_int(SCALAR, F.sum_reduce(SCALAR, comb(consts, tables), axis=0))
    before = [t.clone() for t in tables]
    (t_dev, tj), (t_host, _) = _post_challenge(), _post_challenge()
    want = JSC.prove_custom_device(
        claim, tuple(jnp.asarray(ints_to_limbs(v)) for v in vals),
        tuple(jnp.asarray(ints_to_limbs([c])[0]) for c in cvals), key, degree, tj, b"cs")
    got = TSC.prove_custom_device(claim, tables, consts, key, degree, t_dev, b"cs")
    host = TSC.prove_custom(claim, tables, consts, key, degree, t_host, b"cs")
    assert got == want == host
    rounds, rs, finals, e = got
    assert len(rounds) == n.bit_length() - 1 and all(len(r) == degree + 1 for r in rounds)
    assert all(torch.equal(a, b) for a, b in zip(before, tables))
    after = tj.challenge_scalar(b"after")
    assert t_dev.challenge_scalar(b"after") == after == t_host.challenge_scalar(b"after")
    t_ver, _ = _post_challenge()
    assert TSC.verify_custom(claim, rounds, degree, t_ver, b"cs") == (e, rs)
    final_limbs = tuple(F.from_ints(SCALAR, [v]) for v in finals)
    assert F.to_int(SCALAR, comb(consts, final_limbs)[0]) == e


def test_prove_custom_device_one_row_has_no_rounds():
    """A cube of one row: no rounds, the final values are the tables',
    and the host transcript is left as it was."""
    vals, cvals, _ = _case("spark_table", 3, 4, 2, 1)
    tables = tuple(F.from_ints(SCALAR, v) for v in vals)
    consts = tuple(F.from_int(SCALAR, c) for c in cvals)
    t_dev, _ = _post_challenge()
    t_ref, _ = _post_challenge()
    got = TSC.prove_custom_device(7, tables, consts, "spark_table", 3, t_dev, b"cs")
    assert got == ([], [], tuple(v[0] for v in vals), 7)
    assert t_dev.challenge_scalar(b"after") == t_ref.challenge_scalar(b"after")


def test_prove_custom_device_needs_the_post_challenge_offsets():
    vals, cvals, _ = _case("spark_table", 3, 4, 2, 8)
    tables = tuple(F.from_ints(SCALAR, v) for v in vals)
    consts = tuple(F.from_int(SCALAR, c) for c in cvals)
    t = TTranscript(b"custom test")
    t.append_scalar(b"x", (1).to_bytes(32, "little"))  # mid-operation: not after a challenge
    with pytest.raises(AssertionError, match="post-challenge"):
        TSC.prove_custom_device(0, tables, consts, "spark_table", 3, t, b"cs")


def test_spark_prove_eval_runs_prove_custom_device_three_times(monkeypatch):
    """SPARK's entry sumcheck and both table sumchecks go through
    prove_custom_device, never through the host-driven form, and the
    SNARK proof verifies."""
    calls = []
    real = TSC.prove_custom_device

    def spy(claim, tables, consts, key, degree, transcript, label):
        calls.append((key, degree, label))
        return real(claim, tables, consts, key, degree, transcript, label)

    def host_form(*a, **kw):
        raise AssertionError("spark ran the host-driven prove_custom")

    monkeypatch.setattr(TSC, "prove_custom_device", spy)
    monkeypatch.setattr(TSC, "prove_custom", host_form)
    shape, zvars = TR.random_satisfiable(4, 4)
    dev = shape.to_device("cpu")
    comm = TSP.commit(dev)
    proof = TSN.prove(dev, comm, zvars, [])
    assert [c[:2] for c in calls] == [("spark_entry4", 4), ("spark_table", 3),
                                      ("spark_table", 3)]
    assert calls[0][2].endswith(b"/entry") and calls[1][2].endswith(b"/row/table") \
        and calls[2][2].endswith(b"/col/table")
    assert TSN.verify(dev, comm, [], proof)


def _args(key="spark_table", k=4, kc=2, n=8):
    return (torch.zeros((k, n, 22), dtype=torch.int32), torch.zeros((kc, 22), dtype=torch.int32))


@pytest.mark.parametrize("args,match", [
    pytest.param((*_args(k=5), "spark_table", 3), "takes 4 tables", id="table count"),
    pytest.param((*_args(kc=3), "spark_table", 3), "takes 4 tables and 2 consts",
                 id="const count"),
    pytest.param((*_args(), "spark_table", 4), "of degree 3", id="degree"),
    pytest.param((*_args(), "no_such_comb", 3), "no combination registered", id="unknown key"),
    pytest.param((torch.zeros((4, 8, 21), dtype=torch.int32),
                  torch.zeros((2, 22), dtype=torch.int32), "spark_table", 3),
                 r"\[k, n, 22\]", id="shape"),
    pytest.param((torch.zeros((4, 8, 22), dtype=torch.int32),
                  torch.zeros((2, 21), dtype=torch.int32), "spark_table", 3),
                 r"\[kc, 22\]", id="consts shape"),
    pytest.param((*_args(n=6), "spark_table", 3), "power-of-two", id="ragged first round"),
])
def test_custom_round_argument_errors(args, match):
    with pytest.raises(ValueError, match=match):
        CK.custom_round(*args)


def test_custom_round_challenge_and_device_errors():
    stacked, consts = _args()
    with pytest.raises(ValueError, match="previous active half"):
        CK.custom_round(stacked, consts, "spark_table", 3, 5, 8)
    with pytest.raises(ValueError, match="tensor challenge"):
        CK.custom_round(stacked, consts, "spark_table", 3, torch.zeros(21, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        CK.custom_round(stacked.to("meta"), consts.to("meta"), "spark_table", 3)
    # no fallback: the kernel's wrapper refuses what it cannot launch, and
    # has nothing for a combination without a CUDA form
    with pytest.raises(ValueError, match="CUDA device"):
        CK.custom_round_cuda(stacked, consts, "spark_table", 3)
    CK.register_comb("test_only_sum", lambda c, e: e[0])
    try:
        with pytest.raises(ValueError, match="no CUDA combination"):
            CK.custom_round_cuda(stacked, consts, "test_only_sum", 1)
        ev = CK.custom_round(stacked[:1], consts, "test_only_sum", 1)  # the plain form takes it
        assert ev.shape == (1, 22)
    finally:
        del CK._COMB_REGISTRY["test_only_sum"]


@pytest.mark.cuda
@pytest.mark.parametrize("key,degree,k,kc,n", SHAPES, ids=IDS)
def test_custom_round_kernel_matches_plain_on_card(key, degree, k, kc, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vals, cvals, rs = _case(key, degree, k, kc, n)
    base = torch.stack([F.from_ints(SCALAR, v) for v in vals]).cuda()
    consts = F.from_ints(SCALAR, cvals).cuda()
    tk, tp = base.clone(), base.clone()
    assert torch.equal(CK.custom_round_cuda(tk, consts, key, degree),
                       CK.custom_round_plain(tp, consts, key, degree))
    active = n
    for j, r in enumerate(rs[1:]):
        r_t = F.from_int(SCALAR, r, "cuda") if j % 2 else r
        a = CK.custom_round_cuda(tk, consts, key, degree, r_t, active // 2)
        b = CK.custom_round_plain(tp, consts, key, degree, r_t, active // 2)
        active //= 2
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
        assert torch.equal(tk[:, :active], tp[:, :active])
        if active == 1:
            break


def test_custom_kernels_import_without_jax():
    """In a fresh interpreter (this one imported jax through conftest): the
    module and a round on the CPU, with neither jax nor the JAX package
    imported by the end."""
    code = (
        "import sys\n"
        "import torch\n"
        "from otti_tpu_torch.spartan import custom_kernels as CK\n"
        "CK.register_comb('sum0', lambda c, e: e[0])\n"
        "ev = CK.custom_round(torch.zeros((1, 4, 22), dtype=torch.int32),\n"
        "                     torch.zeros((0, 22), dtype=torch.int32), 'sum0', 1)\n"
        "assert tuple(ev.shape) == (1, 22)\n"
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
