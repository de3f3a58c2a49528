"""The port's SNARK mode against otti_tpu.spartan.{spark,snark}.

The SPARK commitment and then the whole ``snark.prove`` on
``tests/test_nizk.py::toy_instance`` must equal the JAX package's byte for
byte; each verifier must accept the other's proof and every tampered proof
must be rejected.  The stages below it (field inversion, Hyrax commitments of
whole cubes, the custom-combination sumcheck) are held in
tests/test_torch_hyrax.py, the command line in tests/test_torch_snark_cli.py.
The port runs on the CPU here (plain versions of its kernels).  Tolerance:
exact equality, this is modular arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from otti_tpu.field.fields import SCALAR
from otti_tpu.spartan import serial as JS
from otti_tpu.spartan import snark as JSN
from otti_tpu.spartan import spark as JSP
from otti_tpu_torch import convert
from otti_tpu_torch.spartan import nizk as TN
from otti_tpu_torch.spartan import r1cs as TR
from otti_tpu_torch.spartan import serial as TS
from otti_tpu_torch.spartan import snark as TSN
from otti_tpu_torch.spartan import spark as TSP
from tests.test_nizk import toy_instance

torch.set_num_threads(1)  # test workers run side by side on shared cores: one thread each

M = SCALAR.modulus


def _ints(n, seed, mod=M):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % mod for _ in range(n)]


# ---- SPARK and the whole SNARK on the toy instance -------------------------

def _port_shape(shape_j):
    return TR.R1CSShape(shape_j.num_cons, shape_j.num_vars, shape_j.num_inputs,
                        list(shape_j.A), list(shape_j.B), list(shape_j.C))


@pytest.fixture(scope="module")
def toy():
    shape_j, vars_, ios = toy_instance()
    dev_j = shape_j.to_device()
    dev_t = _port_shape(shape_j).to_device("cpu")
    comm_j, comm_t = JSP.commit(dev_j), TSP.commit(dev_t)
    return dict(
        dev_j=dev_j, dev_t=dev_t, comm_j=comm_j, comm_t=comm_t, vars=vars_, ios=ios,
        jax=JSN.prove(dev_j, comm_j, vars_, ios), port=TSN.prove(dev_t, comm_t, vars_, ios),
    )


def test_spark_commit_matches_jax(toy):
    cj, ct = toy["comm_j"], toy["comm_t"]
    assert (ct.mu_n, ct.mu_x, ct.mu_y) == (cj.mu_n, cj.mu_x, cj.mu_y)
    assert (ct.comm_row, ct.comm_col, ct.comm_val) == (cj.comm_row, cj.comm_col, cj.comm_val)
    assert ct.transcript_bytes() == cj.transcript_bytes()
    assert np.array_equal(ct.row_idx, cj.row_idx) and np.array_equal(ct.col_idx, cj.col_idx)
    for name in ("row_f", "col_f", "val"):
        assert np.array_equal(getattr(ct, name).numpy(), np.asarray(getattr(cj, name))), name


@pytest.mark.parametrize("fn", ["_counts_to_field", "_int_vec_to_field", "_sel_table",
                                "_id_mle_eval", "_sel_mle_eval"])
def test_spark_helpers_match_jax(fn):
    idx = np.array([0, 3, 3, 1, 0, 0, 7, 4097], np.int32)
    ws = _ints(4, 80)
    if fn == "_counts_to_field":
        got, want = TSP._counts_to_field(idx % 8, 8), JSP._counts_to_field(idx % 8, 8)
    elif fn == "_int_vec_to_field":
        got, want = TSP._int_vec_to_field(idx), JSP._int_vec_to_field(idx)
    elif fn == "_sel_table":
        got, want = TSP._sel_table(ws, 4), JSP._sel_table(ws, 4)
    elif fn == "_id_mle_eval":
        assert TSP._id_mle_eval(ws[:3], 3) == JSP._id_mle_eval(ws[:3], 3)
        assert TSP._id_mle_eval([1, 0, 1], 3) == 5
        return
    else:
        assert TSP._sel_mle_eval(ws, ws[:2]) == JSP._sel_mle_eval(ws, ws[:2])
        assert TSP._sel_mle_eval(ws, [1, 0]) == ws[2]
        return
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_snark_proof_bytes_equal_jax(toy):
    assert TS.dumps(toy["port"]) == JS.dumps(toy["jax"])
    assert toy["port"].size_bytes() == toy["jax"].size_bytes()
    assert list(toy["port"].spark_proof.entry_claims) == list(toy["jax"].spark_proof.entry_claims)


def test_snark_from_a_converted_commitment(toy):
    """``convert.spark_commitment`` hands the JAX package's commitment to the
    port's prover: the same proof."""
    cj = toy["comm_j"]
    comm = convert.spark_commitment(
        cj.mu_n, cj.comm_row, cj.comm_col, cj.comm_val, cj.mu_x, cj.mu_y, cj.row_idx,
        cj.col_idx, np.asarray(cj.row_f), np.asarray(cj.col_f), np.asarray(cj.val))
    proof = TSN.prove(toy["dev_t"], comm, toy["vars"], toy["ios"])
    assert TS.dumps(proof) == JS.dumps(toy["jax"])
    assert TSN.verify(toy["dev_t"], comm, toy["ios"], proof)


def test_each_snark_verifier_accepts_the_others_proof(toy):
    assert TSN.verify(toy["dev_t"], toy["comm_t"], toy["ios"], toy["port"])
    assert TSN.verify(toy["dev_t"], toy["comm_t"], toy["ios"], TS.loads(JS.dumps(toy["jax"])))
    assert JSN.verify(toy["dev_j"], toy["comm_j"], toy["ios"], JS.loads(TS.dumps(toy["port"])))


def _tampered(proof, case):
    sp = proof.spark_proof
    ea, eb, ec = proof.evals_abc
    if case == "eval_a":
        return dataclasses.replace(proof, evals_abc=((ea + 1) % M, eb, ec))
    if case == "eval_b":  # eB alone: the selector must bind each block's sum apart
        return dataclasses.replace(proof, evals_abc=(ea, (eb + 1) % M, ec))
    if case == "logup_sum":
        return dataclasses.replace(
            proof, spark_proof=dataclasses.replace(sp, s_R_row=(sp.s_R_row + 1) % M))
    if case == "opening":
        b0 = sp.entry_opening
        return dataclasses.replace(proof, spark_proof=dataclasses.replace(
            sp, entry_opening=dataclasses.replace(b0, z1=(b0.z1 + 1) % M)))
    if case == "side_claim":
        side = dataclasses.replace(sp.side_col, claim_m=(sp.side_col.claim_m + 1) % M)
        return dataclasses.replace(proof, spark_proof=dataclasses.replace(sp, side_col=side))
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["inputs", "eval_a", "eval_b", "logup_sum", "opening",
                                  "side_claim"])
def test_snark_tampering_is_rejected(toy, case):
    """The cases of tests/test_snark.py, and one claim of a table side."""
    ios, proof = toy["ios"], toy["port"]
    if case == "inputs":
        ios = [(x + 1) % M for x in ios]
    else:
        proof = _tampered(proof, case)
    assert not TSN.verify(toy["dev_t"], toy["comm_t"], ios, proof)
    assert not JSN.verify(toy["dev_j"], toy["comm_j"], ios, JS.loads(TS.dumps(proof)))


def test_snark_serial_round_trip(toy):
    text = TS.dumps(toy["port"])
    back = TS.loads(text)
    assert back == toy["port"] and TS.dumps(back) == text
    assert type(back).__name__ == "SNARKProof"
    assert type(back.spark_proof).__name__ == "SparkEvalProof"
    assert type(back.spark_proof.side_row).__name__ == "SparkSideProof"
    assert isinstance(back.evals_abc, tuple)
    for cls in ("SNARKProof", "SparkEvalProof", "SparkSideProof"):
        assert cls in TS._CLASSES and cls in JS._CLASSES


def test_nizk_proto_changes_the_proof_of_the_base(toy):
    """The SNARK's base proof is the plain NIZK under the SNARK's label."""
    base = TN.prove(toy["dev_t"], toy["vars"], toy["ios"], proto=TSN.PROTO)
    assert TS.dumps(base) == TS.dumps(toy["port"].base)
    assert not TN.verify(toy["dev_t"], toy["ios"], base)  # verify replays the NIZK's own label
