"""A plain verifier of the zero-knowledge Spartan NIZK, over the proof's
canonical JSON.

The argument (Spartan with Hyrax commitments, otti-tpu's label schedule):
the witness's Hyrax rows are committed; a sumcheck on eq(tau) (Az Bz - Cz)
proves the claim 0, each round's polynomial committed and tied to the
running claim by a dot-product proof; committed vA, vB, vC with a product
proof and an equality proof close phase 1; a second sumcheck on the
random combination of the matrices against z leads to ry; the witness's
value at ry[1:] is opened by a blinded Bulletproofs inner-product argument
against the row commitments folded by eq(ry[1:mu_rows+1]); an equality
proof closes phase 2 against the verifier's own evaluation of the sparse
matrices at (rx, ry).  Generators come from SHAKE256 under the label
"gens_pc" (G_i, H, and the inner product's Q).  Fiat-Shamir is Merlin.

The verifier reads only the proof's JSON, the R1CS the reference lowered
from the LP, and the public inputs.  ``verify`` returns True or False;
a malformed proof is False.
"""

from __future__ import annotations

import functools
import json

from . import curve as C
from .transcript import Transcript

L = C.L
PROTO = b"otti-tpu Spartan zkNIZK v1"
LABEL = b"gens_pc"


@functools.lru_cache(maxsize=None)
def generators(n: int) -> tuple:
    """(G_0..G_{n-1}, H, Q)."""
    base = b"otti-tpu gens" + LABEL
    G = tuple(C.hash_point(base + i.to_bytes(8, "little")) for i in range(n))
    return G, C.hash_point(base + b"/blinding"), C.hash_point(base + b"/ipa-q")


def _plain(x):
    """The JSON envelope's values: bytes, big ints, dataclass fields."""
    if isinstance(x, dict):
        if "__bytes__" in x:
            return bytes.fromhex(x["__bytes__"])
        if "__int__" in x:
            return int(x["__int__"], 16)
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


class _Reject(Exception):
    pass


def _point(b) -> tuple:
    p = C.decode(b) if isinstance(b, bytes) else None
    if p is None:
        raise _Reject("not a ristretto255 encoding")
    return p


def _int(x) -> int:
    if not isinstance(x, int) or isinstance(x, bool):
        raise _Reject("not a scalar")
    return x


def _eq_table(r: list) -> list:
    """eq(r, x) for every x of the hypercube, r[0] the index's top bit."""
    t = [1]
    for rj in r:
        nr = (1 - rj) % L
        t = [v for x in t for v in (x * nr % L, x * rj % L)]
    return t


def _eq(a: list, b: list) -> int:
    acc = 1
    for x, y in zip(a, b, strict=True):
        acc = acc * ((x * y + (1 - x) * (1 - y)) % L) % L
    return acc


def _mle(vals: list, r: list) -> int:
    cur = [v % L for v in vals]
    for rj in r:
        h = len(cur) // 2
        cur = [(cur[i] + rj * (cur[h + i] - cur[i])) % L for i in range(h)]
    return cur[0]


def _hyrax_dims(nvp: int) -> tuple:
    mu = (nvp - 1).bit_length() if nvp > 1 else 0
    return mu - (mu + 1) // 2, (mu + 1) // 2


def _commit(v: int, b: int, G, H) -> tuple:
    return C.msm([G[0], H], [v, b])


def _dot_product(t: Transcript, G, H, a: list, Cx, Cy, p: dict) -> None:
    t.protocol(b"dot product proof")
    t.message(b"Cx", C.encode(Cx))
    t.message(b"Cy", C.encode(Cy))
    for ai in a:
        t.scalar(b"a", ai)
    delta, beta = _point(p["delta"]), _point(p["beta"])
    t.message(b"delta", C.encode(delta))
    t.message(b"beta", C.encode(beta))
    c = t.challenge(b"c")
    z = [_int(v) for v in p["z"]]
    if len(z) != len(a):
        raise _Reject("dot product: length")
    if not C.equal(C.add(C.msm([Cx], [c]), delta),
                   C.msm(list(G[:len(z)]) + [H], z + [_int(p["z_delta"])])):
        raise _Reject("dot product: vector")
    za = sum(x * y for x, y in zip(z, a)) % L
    if not C.equal(C.add(C.msm([Cy], [c]), beta), _commit(za, _int(p["z_beta"]), G, H)):
        raise _Reject("dot product: value")


def _sumcheck(t: Transcript, phase: bytes, degree: int, C_claim, rounds: int, p: dict, G, H):
    """The zk sumcheck's rounds: (challenges, commitment to the last claim)."""
    polys, evals, dots = p["comm_polys"], p["comm_evals"], p["dot_proofs"]
    if not len(polys) == len(evals) == len(dots) == rounds:
        raise _Reject("sumcheck: round count")
    rs, C_e = [], C_claim
    for j in range(rounds):
        C_poly = _point(polys[j])
        t.message(phase + b"/comm_poly", polys[j])
        r = t.challenge(phase + b"/r")
        rs.append(r)
        C_next = _point(evals[j])
        t.message(phase + b"/comm_eval", evals[j])
        w0, w1 = t.challenge(phase + b"/w0"), t.challenge(phase + b"/w1")
        a = [(w0 * (2 if k == 0 else 1) + w1 * pow(r, k, L)) % L for k in range(degree + 1)]
        _dot_product(t, G, H, a, C_poly, C.msm([C_e, C_next], [w0, w1]), dots[j])
        C_e = C_next
    return rs, C_e


def _equality(t: Transcript, H, C1, C2, p: dict) -> None:
    t.protocol(b"equality proof")
    t.message(b"C1", C.encode(C1))
    t.message(b"C2", C.encode(C2))
    alpha = _point(p["alpha"])
    t.message(b"alpha", C.encode(alpha))
    c = t.challenge(b"c")
    if not C.equal(C.msm([H], [_int(p["z"])]), C.add(C.msm([C.add(C1, C.neg(C2))], [c]), alpha)):
        raise _Reject("equality proof")


def _product(t: Transcript, G, H, Cx, Cy, Cz, p: dict) -> None:
    t.protocol(b"product proof")
    for lbl, P_ in ((b"Cx", Cx), (b"Cy", Cy), (b"Cz", Cz)):
        t.message(lbl, C.encode(P_))
    alpha, beta, delta = _point(p["alpha"]), _point(p["beta"]), _point(p["delta"])
    for lbl, P_ in ((b"alpha", alpha), (b"beta", beta), (b"delta", delta)):
        t.message(lbl, C.encode(P_))
    c = t.challenge(b"c")
    z1, z2, z3, z4, z5 = (_int(v) for v in p["z"])
    if not (C.equal(C.add(alpha, C.msm([Cx], [c])), _commit(z1, z2, G, H))
            and C.equal(C.add(beta, C.msm([Cy], [c])), _commit(z3, z4, G, H))
            and C.equal(C.add(delta, C.msm([Cz], [c])), C.msm([Cx, H], [z3, z5]))):
        raise _Reject("product proof")


def _dual_base(t: Transcript, G0, Q, H, C1, C2, p: dict) -> None:
    t.protocol(b"dual base equality proof")
    t.message(b"C1", C.encode(C1))
    t.message(b"C2", C.encode(C2))
    alpha, beta = _point(p["alpha"]), _point(p["beta"])
    t.message(b"alpha", C.encode(alpha))
    t.message(b"beta", C.encode(beta))
    c = t.challenge(b"c")
    z, z1, z2 = _int(p["z"]), _int(p["z1"]), _int(p["z2"])
    if not (C.equal(C.msm([G0, H], [z, z1]), C.add(C.msm([C1], [c]), alpha))
            and C.equal(C.msm([Q, H], [z, z2]), C.add(C.msm([C2], [c]), beta))):
        raise _Reject("dual base equality proof")


def _bullet(t: Transcript, G, H, Q, a: list, P_, p: dict) -> None:
    """<x, a> opened against P = <x, G> + <x, a> Q + r H in log2(n) rounds."""
    n = len(a)
    k = n.bit_length() - 1
    Ls, Rs = p["L_vec"], p["R_vec"]
    if len(Ls) != k or len(Rs) != k:
        raise _Reject("bullet: round count")
    t.protocol(b"bullet opening v1")
    t.u64(b"n", n)
    us = []
    for Lb, Rb in zip(Ls, Rs):
        t.message(b"L", Lb)
        t.message(b"R", Rb)
        us.append(t.challenge(b"u"))
    t.message(b"delta", p["delta"])
    e = t.challenge(b"e")
    if any(u == 0 for u in us):
        raise _Reject("bullet: zero challenge")
    uis = [pow(u, L - 2, L) for u in us]
    af = [v % L for v in a]
    for u, ui in zip(us, uis):
        h = len(af) // 2
        af = [(ui * af[i] + u * af[h + i]) % L for i in range(h)]
    s = [1]
    for u, ui in zip(us, uis):
        s = [v for x in s for v in (x * ui % L, x * u % L)]
    z1, z2 = _int(p["z1"]) % L, _int(p["z2"]) % L
    pts = [P_, _point(p["delta"])] + list(G[:n]) + [Q, H]
    scs = [e, 1] + [-z1 * si % L for si in s] + [-z1 * af[0] % L, -z2 % L]
    for j in range(k):
        pts += [_point(Ls[j]), _point(Rs[j])]
        scs += [e * us[j] * us[j] % L, e * uis[j] * uis[j] % L]
    if not C.equal(C.msm(pts, scs), C.IDENTITY):
        raise _Reject("bullet opening")


def _matrix_eval(r1cs, rx: list, ry: list, weights: tuple) -> int:
    """weights . (A~, B~, C~)(rx, ry)."""
    erx, ery = _eq_table(rx), _eq_table(ry)
    acc = [0, 0, 0]
    for r, row in enumerate(r1cs.rows):
        for m in range(3):
            if row[m]:
                acc[m] += erx[r] * (sum(v * ery[col] for col, v in row[m]) % L)
    return sum(w * (x % L) for w, x in zip(weights, acc)) % L


def _verify(r1cs, inputs: list, proof: dict) -> None:
    if proof.get("__type__") != "ZKNIZKProof":
        raise _Reject("not a zk NIZK proof")
    nvp = r1cs.num_vars_padded
    mu_rows, mu_cols = _hyrax_dims(nvp)
    G, H, Q = generators(max(1 << mu_cols, 4))
    t = Transcript(PROTO)
    t.message(b"R1CS", r1cs.digest())
    t.u64(b"num_inputs", len(inputs))
    for x in inputs:
        t.scalar(b"input", x)
    rows = proof["comm_vars"]
    if len(rows) != 1 << mu_rows:
        raise _Reject("row commitments: count")
    for enc in rows:
        t.message(b"poly_commitment", enc)
    mu_x = (r1cs.num_cons_padded - 1).bit_length()
    tau = [t.challenge(b"challenge_tau") for _ in range(mu_x)]
    rx, C_e1 = _sumcheck(t, b"sc1", 3, C.IDENTITY, mu_x, proof["sc1"], G, H)
    CA, CB, CC = (_point(b) for b in proof["comm_abc"])
    for lbl, enc in zip((b"CA", b"CB", b"CC"), proof["comm_abc"]):
        t.message(lbl, enc)
    C_ab = _point(proof["comm_ab"])
    _product(t, G, H, CA, CB, C_ab, proof["proof_ab"])
    _equality(t, H, C_e1, C.msm([C.add(C_ab, C.neg(CC))], [_eq(tau, rx)]), proof["eq1"])
    r_abc = tuple(t.challenge(lbl) for lbl in (b"challenge_Az", b"challenge_Bz", b"challenge_Cz"))
    mu_y = (2 * nvp - 1).bit_length()
    ry, C_e2 = _sumcheck(t, b"sc2", 2, C.msm([CA, CB, CC], list(r_abc)), mu_y, proof["sc2"], G, H)
    r_w = ry[1:]
    C_u = C.msm([_point(b) for b in rows], _eq_table(r_w[:mu_rows]))
    C_w, C_wq = _point(proof["comm_w"]), _point(proof["comm_wq"])
    _dual_base(t, G[0], Q, H, C_w, C_wq, proof["base_eq"])
    _bullet(t, G, H, Q, _eq_table(r_w[mu_rows:]), C.add(C_u, C_wq), proof["bullet"])
    io = [1] + list(inputs) + [0] * (nvp - 1 - len(inputs))
    v_m = _matrix_eval(r1cs, rx, ry, r_abc)
    rhs = C.msm([C_w, G[0]], [v_m * (1 - ry[0]), v_m * ry[0] % L * _mle(io, r_w)])
    _equality(t, H, C_e2, rhs, proof["eq2"])


def verify(r1cs, inputs: list, proof_json: str) -> bool:
    """Whether ``proof_json`` proves that ``r1cs`` with public ``inputs`` is
    satisfiable."""
    try:
        _verify(r1cs, list(inputs), _plain(json.loads(proof_json)))
    except (_Reject, KeyError, TypeError, ValueError, IndexError):
        return False
    return True
