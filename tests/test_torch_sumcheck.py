"""Port sumcheck (round kernel's plain version + provers) against
otti_tpu.spartan.sumcheck's XLA round kernels and provers.

Every round of a full sumcheck is compared, so each table size covers every
active size from n down to 1 (the JAX kernels are fixed-shape with a traced
active size); n = 2 and 8 add the first round and the bare final bind on
the smallest tables.  Bound tables are compared on their active prefix only: the
JAX kernels also write lanes past it.  Tolerance: exact canonical equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otti_tpu.field import ops as JF
from otti_tpu.field.fields import SCALAR, int_to_limbs, ints_to_limbs, limbs_to_int
from otti_tpu.spartan import sumcheck as JS
from otti_tpu.transcript.merlin import Transcript
from otti_tpu_torch import _build
from otti_tpu_torch.field import ops as F
from otti_tpu_torch.spartan import sumcheck as TS
from otti_tpu_torch.spartan import sumcheck_kernels as SK

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus
N = 1 << 10  # one size: the JAX kernels compile once per table size


def _tables(n, k, seed):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(40), "little") % M for _ in range(n)] for _ in range(k)]


def _jax_ints(x):
    arr = np.asarray(JF.canon_jit(SCALAR)(x))
    return [limbs_to_int(row) % M for row in arr.reshape(-1, arr.shape[-1])]


def _run_both(n, degree, seed):
    """Drive the JAX round kernels and the port's plain round side by side
    through a full sumcheck; yields (round, jax evals, port evals, jax
    tables, port tables, active size after the round)."""
    k = 4 if degree == 3 else 2
    vals = _tables(n, k, seed)
    jt = tuple(jnp.asarray(ints_to_limbs(v)) for v in vals)
    tt = [F.from_ints(SCALAR, v) for v in vals]
    rs = _tables(n.bit_length(), 1, seed + 1)[0]
    first = JS._round_cubic_kernel(n) if degree == 3 else JS._round_quad_kernel(n)
    step = JS._step_cubic_kernel(n) if degree == 3 else JS._step_quad_kernel(n)
    yield 0, first(*jt, jnp.int32(n // 2)), SK.sumcheck_round_plain(tt, degree), jt, tt, n
    active, rnd = n, 1
    while active > 1:
        r = rs[rnd]
        rl = jnp.asarray(int_to_limbs(r))
        if active > 2:
            ev_j, jt = step(rl, jnp.int32(active // 2), *jt)
        else:
            ev_j, jt = None, JS._bind_kernel(n, k)(rl, jnp.int32(1), *jt)
        ev_t = SK.sumcheck_round_plain(tt, degree, r, active // 2)
        active //= 2
        yield rnd, ev_j, ev_t, jt, tt, active
        rnd += 1


@pytest.mark.parametrize("n", [2, 8, N])
@pytest.mark.parametrize("degree", [3, 2])
def test_plain_round_matches_jax_kernels(degree, n):
    rounds = 0
    for rnd, ev_j, ev_t, jt, tt, active in _run_both(n, degree, seed=n + degree):
        if ev_j is None:
            assert ev_t is None
        else:
            assert F.to_ints(SCALAR, ev_t) == _jax_ints(ev_j), f"round {rnd}"
        for a, b in zip(jt, tt):
            assert F.to_ints(SCALAR, b[:active]) == _jax_ints(a[:active]), f"round {rnd}"
        rounds += 1
    assert rounds == n.bit_length()


def _transcripts():
    tj, tt = Transcript(b"sumcheck test"), Transcript(b"sumcheck test")
    for t in (tj, tt):
        t.append_message(b"seed", b"\x01\x02")
    return tj, tt


def test_prove_cubic_matches_jax():
    n = N
    vals = _tables(n, 4, 31)
    # a zero-sum instance, as phase 1 proves: C = A * B everywhere
    vals[3] = [a * b % M for a, b in zip(vals[1], vals[2])]
    tj, tt = _transcripts()
    want = JS.prove_cubic(0, *(jnp.asarray(ints_to_limbs(v)) for v in vals), tj, b"sc1")
    got = TS.prove_cubic(0, *(F.from_ints(SCALAR, v) for v in vals), tt, b"sc1")
    assert got[0] == want[0] and got[1] == want[1]  # round evals, challenges
    assert got[2] == want[2] and got[3] == want[3]  # final values, claim
    assert tt.challenge_scalar(b"next") == tj.challenge_scalar(b"next")
    tv = _transcripts()[1]
    e, rs = TS.verify_rounds(0, got[0], 3, tv, b"sc1")
    assert rs == got[1] and e == got[3]


def test_prove_quad_matches_jax():
    n = N
    vals = _tables(n, 2, 32)
    claim = sum(a * b for a, b in zip(*vals)) % M
    tj, tt = _transcripts()
    want = JS.prove_quad(claim, *(jnp.asarray(ints_to_limbs(v)) for v in vals), tj, b"sc2")
    got = TS.prove_quad(claim, *(F.from_ints(SCALAR, v) for v in vals), tt, b"sc2")
    assert got == want
    bad = [list(p) for p in got[0]]
    bad[-1][2] = (bad[-1][2] + 1) % M  # a changed last round moves the claim
    e, _ = TS.verify_rounds(claim, bad, 2, _transcripts()[1], b"sc2")
    assert e != got[3]
    bad[0][2] = (bad[0][2] + 1) % M  # an earlier one breaks the next round
    with pytest.raises(ValueError):
        TS.verify_rounds(claim, bad, 2, _transcripts()[1], b"sc2")
    with pytest.raises(ValueError):
        TS.verify_rounds((claim + 1) % M, got[0], 2, _transcripts()[1], b"sc2")


def test_round_rejects_bad_arguments():
    t = [F.from_ints(SCALAR, [1, 2, 3, 4]) for _ in range(2)]
    with pytest.raises(ValueError):
        SK.sumcheck_round(t, 3)  # cubic takes four tables
    with pytest.raises(ValueError):
        SK.sumcheck_round(t, 2, r=5, prev_half=4)  # 2 * ah > n
    with pytest.raises(ValueError):
        SK.sumcheck_round_cuda(t, 2)  # CPU tables never reach the kernel
    assert _build.LAUNCHES["sumcheck_round"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [3, 2])
def test_round_kernel_matches_plain_on_card(degree):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 1024
    k = 4 if degree == 3 else 2
    base = [F.from_ints(SCALAR, v).cuda() for v in _tables(n, k, 41)]
    tk, tp = [t.clone() for t in base], [t.clone() for t in base]
    rs = _tables(n.bit_length(), 1, 42)[0]
    assert torch.equal(SK.sumcheck_round_cuda(tk, degree), SK.sumcheck_round_plain(tp, degree))
    active = n
    for r in rs[1:]:
        ek = SK.sumcheck_round_cuda(tk, degree, r, active // 2)
        ep = SK.sumcheck_round_plain(tp, degree, r, active // 2)
        active //= 2
        assert (ek is None and ep is None) or torch.equal(ek, ep)
        for a, b in zip(tk, tp):
            assert torch.equal(a[:active], b[:active])
