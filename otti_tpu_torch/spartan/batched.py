"""Batched proving: B instances of one padded shape proved side by side
(port of otti_tpu/spartan/batched.py).

The JAX package proves a batch as one vmapped device program.  Here the
device chain of hybrid.py runs once for the whole batch: every table,
challenge and commitment of it carries a leading axis B, so that each step
is the same launches as for one instance, over B times the data.  The
instances' COO matrices are stacked into one ``R1CSDevice`` with
instance-offset indices (``R1CSDevice.stack``), so that each sparse product
is one gather, one multiply and one ``index_add_``; the Fiat-Shamir
transcripts are one ``[B, 200]`` sponge state (transcript/device.py: every
instance is handed over at the same post-challenge offsets, so one K3
launch permutes them all); a sumcheck round is one launch of kernel 2 over
``[B, n, 22]`` tables (spartan/sumcheck_kernels.py); a zk round's
commitments are one comb MSM over the B instances' rows and one K4
encoding.

The witness rows of all B instances are committed by one comb MSM and
encoded on the host (transfer 1); each instance's host transcript absorbs
its own and draws tau.  After the device chain the materials come back in
two packed transfers (transfer 2), and the host assembles each proof with
the single-instance code (fused.assemble_plain_proof,
zkfused.assemble_zk_proof).

One instance is a batch of one: hybrid.prove and hybrid.prove_zk call
``prove_many`` and ``prove_many_zk`` with it.  Proofs are byte-identical
to the host-transcript provers' (nizk.prove; with the same seed
zknizk.prove), so the standard verifiers check them one by one
(tests/test_torch_batched.py).
"""

from __future__ import annotations

import os

import torch

from .. import metrics
from ..field.fields import N_LIMBS
from ..transcript.merlin import Transcript
from . import commitments, r1cs
from .fused import assemble_plain_proof
from .nizk import GENS_LABEL, PROTO, _hyrax_dims, _sb, _vec


def BatchedR1CS(devs: list) -> r1cs.R1CSDevice:
    """B instances of equal padded dimensions as one stacked device R1CS
    (the JAX package's name for ``R1CSDevice.stack``)."""
    return r1cs.R1CSDevice.stack(devs)


def eval_at_batched(stacked: r1cs.R1CSDevice, e_rx: torch.Tensor, e_ry: torch.Tensor):
    """Batched A~/B~/C~(rx, ry): [B, 3, 22] stacked evaluations."""
    return torch.stack(stacked.eval_at(e_rx, e_ry), dim=1)


def _host_setup(devs, vars_list, inputs_list, proto, row_blinds=None):
    """The host half of the front: the instances' host transcripts, one comb
    MSM over every instance's witness rows and their encodings (transfer
    1), and tau of each.  Returns (stacked R1CS, pristine transcripts,
    transcripts at tau, comm_encs, taus (host ints), ws [B, nvp, 22],
    (mu_rows, mu_cols, mu_x))."""
    from .hybrid import _fork

    stacked = r1cs.R1CSDevice.stack(devs)
    device = stacked.device
    nb, nvp = len(devs), stacked.num_vars
    mu_rows, mu_cols = _hyrax_dims(nvp)
    mu_x = (stacked.num_cons - 1).bit_length()
    rows_per = 1 << mu_rows

    transcripts = []
    for d, inputs in zip(devs, inputs_list):
        t = Transcript(proto)
        t.append_message(b"R1CS", d.digest)
        t.append_u64(b"num_inputs", len(inputs))
        for x in inputs:
            t.append_scalar(b"input", _sb(x))
        transcripts.append(t)
    metrics.add("constraints", stacked.num_cons * nb)
    metrics.add("msm_points", nvp * nb)

    ws = _vec([x for v in vars_list for x in list(v) + [0] * (nvp - len(v))],
              device).reshape(nb, nvp, N_LIMBS)
    blinds = [b for inst in row_blinds for b in inst] if row_blinds else [0] * (nb * rows_per)
    with metrics.timed("commit"):
        comm_flat = commitments.encode_points(commitments.commit_rows(
            ws.reshape(nb * rows_per, 1 << mu_cols, N_LIMBS), blinds, GENS_LABEL))
    comm_encs = [comm_flat[b * rows_per : (b + 1) * rows_per] for b in range(nb)]

    # replicas advance to tau; the pristine transcripts replay in the plain tail
    forks, taus = [], []
    for t, encs in zip(transcripts, comm_encs):
        t2 = _fork(t)
        for enc in encs:
            t2.append_point(b"poly_commitment", enc)
        taus.append(t2.challenge_vector(b"challenge_tau", mu_x))
        forks.append(t2)
    return stacked, transcripts, forks, comm_encs, taus, ws, (mu_rows, mu_cols, mu_x)


def _device_setup(forks, taus, ws, inputs_list, nvp: int):
    """The device half: the transcripts as one [B, 200] state, tau
    [B, mu_x, 22] and z [B, num_z, 22], each uploaded once.  A batch of one
    drops the batch axis (``ws`` too): the chain's torch ops cost the host
    less on [n, 22] than on [1, n, 22] tensors (PERF.md)."""
    from .hybrid import _check_handoff

    device = ws.device
    nb = len(taus)
    td = _check_handoff(forks, device)
    tau = _vec([x for tau in taus for x in tau], device).reshape(nb, -1, N_LIMBS)
    n_in = max(len(i) for i in inputs_list)
    ins = (_vec([x for i in inputs_list for x in list(i) + [0] * (n_in - len(i))], device)
           .reshape(nb, n_in, N_LIMBS) if n_in else None)
    if nb == 1:
        ws, tau, ins = ws[0], tau[0], ins[0] if n_in else None
    return td, tau, ws, r1cs.assemble_z(ws, ins, nvp)


@torch.inference_mode()
def prove_many(devs: list, vars_list: list, inputs_list: list, proto: bytes = None) -> list:
    """-> one NIZKProof an instance (plain mode), byte-identical to
    nizk.prove's; the device chain of hybrid.py runs once for the batch,
    with two device->host transfers whatever B."""
    from .hybrid import _device_chain, _fetch_packed, _no_host_sync

    stacked, transcripts, forks, comm_encs, taus, ws, (mu_rows, mu_cols, mu_x) = \
        _host_setup(devs, vars_list, inputs_list, proto or PROTO)
    with metrics.timed("device_chain"):
        td, tau, ws, zs = _device_setup(forks, taus, ws, inputs_list, stacked.num_vars)
        with _no_host_sync(stacked.device):
            outs = _device_chain(stacked, td, tau, zs, ws, mu_rows, mu_cols)
        got, _ = _fetch_packed(list(outs), [])
        r1_np, vabc_np, r2_np, u_np, cw_np = got if len(devs) > 1 else (a[None] for a in got)
    metrics.add("sumcheck_rounds", mu_x * len(devs))
    with metrics.timed("host_tail"):
        return [assemble_plain_proof(transcripts[b], comm_encs[b], r1_np[b], vabc_np[b],
                                     r2_np[b], u_np[b], cw_np[b], mu_x, mu_rows, mu_cols)
                for b in range(len(devs))]


@torch.inference_mode()
def prove_many_zk(devs: list, vars_list: list, inputs_list: list, seeds: list = None) -> list:
    """-> one ZKNIZKProof an instance, byte-identical to zknizk.prove (and
    zkfused.prove) with the same seed: each instance's blinds come from its
    own BlindSource in zknizk.prove's order."""
    from .hybrid import (_fetch_zk, _first, _no_host_sync, _stage_times, _zk_device_chain,
                         _zk_uploads)
    from .pedersen_host import BlindSource
    from .zkfused import _mid_tables, _round_tables, assemble_zk_proof
    from .zknizk import PROTO as ZK_PROTO

    nb = len(devs)
    seeds = seeds or [os.urandom(32) for _ in range(nb)]
    if len(seeds) != nb:
        raise ValueError(f"{nb} instances and {len(seeds)} seeds")
    rngs = [BlindSource(s) for s in seeds]
    mu_rows, _ = _hyrax_dims(devs[0].num_vars)
    with metrics.timed("blinds"):
        uploads = _zk_uploads(rngs, devs[0], mu_rows)
        row_ints = uploads[0]  # each instance's, as host ints
        row_blinds, sc1, abc, prod, eq1_a, sc2 = (uploads if nb > 1 else _first(uploads))[1:]

    stacked, _, forks, comm_encs, taus, ws, (mu_rows, mu_cols, mu_x) = \
        _host_setup(devs, vars_list, inputs_list, ZK_PROTO, row_blinds=row_ints)
    device = stacked.device
    with metrics.timed("device_chain"), _stage_times():
        td, tau, ws, zs = _device_setup(forks, taus, ws, inputs_list, stacked.num_vars)
        tbls = (_round_tables(3, device), _mid_tables(device), _round_tables(2, device))
        with _no_host_sync(device):
            out = _zk_device_chain(stacked, td, tau, zs, ws, row_blinds, sc1, abc, prod, eq1_a,
                                   sc2, tbls, mu_rows, mu_cols)
        with metrics.timed("fetch"):
            got = _fetch_zk(out)
    if nb == 1:
        got = {k: v if k == "extra" else v[None] for k, v in got.items()}
    metrics.add("sumcheck_rounds", mu_x * nb)
    with metrics.timed("host_tail"):
        return [assemble_zk_proof(devs[b], rngs[b], comm_encs[b],
                                  {k: v[b] for k, v in got.items() if k != "extra"})
                for b in range(nb)]
