# copied from otti_tpu/spartan/bullet.py (host-only; that package path imports jax)
"""Log-sized inner-product (Bulletproofs-style) opening argument.

Replaces the linear-size openings of round 1 — the revealed row-
combination vector of the plain NIZK and the linear DotProductProof of
the ZK path — with the log-round folding argument that reference
Spartan uses for its polynomial-evaluation proof (SURVEY.md §3.5 step 5,
"inner-product/opening proof (log-sized)"; reconstructed role of
Spartan's src/nizk/bullet.rs ``BulletReductionProof`` +
``DotProductProofLog``).  The construction is the standard Bulletproofs
inner-product argument [BBB+18] with per-round blinds so one code path
serves both the transparent (zero blinds, deterministic) and the
zero-knowledge (blinded) provers.

Statement:  P = sum_i x_i * G_i  +  <x, a> * Q  +  r_P * H
for public generators G_0..G_{n-1}, Q, H (pairwise independent — Q is
derived under its own domain-separation label, never a member of the
G family) and a public weight vector ``a``.  The prover knows (x, r_P).

Each of the log2(n) rounds sends two blinded cross-term points

    L_j = MSM(G_R, x_L) + <x_L, a_R> * Q + l_j * H
    R_j = MSM(G_L, x_R) + <x_R, a_L> * Q + r_j * H

absorbs them, draws u_j, and folds

    x' = u x_L + u^{-1} x_R,   a' = u^{-1} a_L + u a_R,
    G' = u^{-1} G_L + u G_R,   r' = r + u^2 l_j + u^{-2} r_j,

preserving the statement shape.  After the rounds a Schnorr proof on
the collapsed base  B = G_hat + a_hat * Q  closes the argument in zero
knowledge.  Proof size: 2*log2(n) + 1 points + 2 scalars — vs n scalars
for the round-1 openings.  The verifier pays one n-point MSM for G_hat
(same asymptotics as reference Spartan's bullet verifier).

All group work is host-native (native/otti_host.cpp); n here is the
Hyrax column count sqrt(num_vars) <= ~2^10, latency-bound not
throughput-bound (SURVEY.md §5.8 host/device boundary discipline).
"""

from __future__ import annotations

import dataclasses
import functools

from ..refimpl import numeric as ref
from ..transcript.keccak import shake256
from ..transcript.merlin import Transcript

L_ORDER = ref.L

PROTOCOL_LABEL = b"bullet opening v1"


@functools.lru_cache(maxsize=None)
def q_point_host(label: bytes) -> ref.EdPoint:
    """Scalar-base generator Q, independent of the G family and H
    (own derivation label; same one-way map as commitments.gen_points_host)."""
    return ref.EdPoint.from_uniform_bytes(
        shake256(b"otti-tpu gens" + label + b"/ipa-q", 64)
    )


def _inv(x: int) -> int:
    return pow(x % L_ORDER, L_ORDER - 2, L_ORDER)


@dataclasses.dataclass
class BulletOpeningProof:
    L_vec: list  # bytes32 per round
    R_vec: list  # bytes32 per round
    delta: bytes  # final Schnorr commitment
    z1: int
    z2: int

    def size_bytes(self) -> int:
        return 32 * (len(self.L_vec) + len(self.R_vec) + 1 + 2)


def prove(
    t: Transcript,
    G: list,
    H: ref.EdPoint,
    Q: ref.EdPoint,
    x: list,
    a: list,
    r_P: int,
    rng=None,
) -> BulletOpeningProof:
    """Prove <x, a> against P = commit_vec(x, r_P) + <x,a>*Q.

    ``rng`` is a pedersen_host.BlindSource for the ZK flavor or None for
    the transparent deterministic flavor (all blinds zero)."""
    from ..native import fold_pairs_host, msm_host

    n = len(x)
    # explicit errors (not assert: must survive python -O; ADVICE r02)
    if not n or (n & (n - 1)) or len(a) != n or len(G) < n:
        raise ValueError("bullet.prove: n must be a power of two with "
                         "matching vector/generator lengths")
    G = list(G[:n])
    x = [v % L_ORDER for v in x]
    a = [v % L_ORDER for v in a]
    t.append_protocol_name(PROTOCOL_LABEL)
    t.append_u64(b"n", n)

    L_vec, R_vec = [], []
    r_hat = r_P % L_ORDER
    while n > 1:
        h = n // 2
        xL, xR = x[:h], x[h:]
        aL, aR = a[:h], a[h:]
        GL, GR = G[:h], G[h:]
        l_b = rng.scalar() if rng else 0
        r_b = rng.scalar() if rng else 0
        cL = sum(xi * ai for xi, ai in zip(xL, aR)) % L_ORDER
        cR = sum(xi * ai for xi, ai in zip(xR, aL)) % L_ORDER
        Lp = msm_host(GR + [Q, H], xL + [cL, l_b])
        Rp = msm_host(GL + [Q, H], xR + [cR, r_b])
        encL, encR = Lp.ristretto_encode(), Rp.ristretto_encode()
        t.append_point(b"L", encL)
        t.append_point(b"R", encR)
        L_vec.append(encL)
        R_vec.append(encR)
        u = t.challenge_scalar(b"u")
        if u % L_ORDER == 0:  # negligible probability; inverting 0 would
            raise ValueError("zero bullet challenge")  # silently corrupt
        ui = _inv(u)
        x = [(u * lo + ui * hi) % L_ORDER for lo, hi in zip(xL, xR)]
        a = [(ui * lo + u * hi) % L_ORDER for lo, hi in zip(aL, aR)]
        G = fold_pairs_host(GL, GR, ui, u)
        r_hat = (r_hat + u * u % L_ORDER * l_b + ui * ui % L_ORDER * r_b) % L_ORDER
        n = h

    x_hat, a_hat, G_hat = x[0], a[0], G[0]
    B = msm_host([G_hat, Q], [1, a_hat])
    d = rng.scalar() if rng else 0
    r_d = rng.scalar() if rng else 0
    delta = msm_host([B, H], [d, r_d])
    enc_d = delta.ristretto_encode()
    t.append_point(b"delta", enc_d)
    e = t.challenge_scalar(b"e")
    return BulletOpeningProof(
        L_vec=L_vec,
        R_vec=R_vec,
        delta=enc_d,
        z1=(d + e * x_hat) % L_ORDER,
        z2=(r_d + e * r_hat) % L_ORDER,
    )


def _fold_challenges(t: Transcript, proof: BulletOpeningProof, n: int):
    """Absorb the round messages, returning the challenge list (shared by
    verify and transcript replay)."""
    t.append_protocol_name(PROTOCOL_LABEL)
    t.append_u64(b"n", n)
    us = []
    for encL, encR in zip(proof.L_vec, proof.R_vec):
        t.append_point(b"L", encL)
        t.append_point(b"R", encR)
        us.append(t.challenge_scalar(b"u"))
    t.append_point(b"delta", proof.delta)
    e = t.challenge_scalar(b"e")
    return us, e


def replay(t: Transcript, proof: BulletOpeningProof, n: int) -> None:
    """Advance ``t`` past the proof's absorb schedule without verifying
    (prover-side transcript reconstruction, e.g. snark.py)."""
    _fold_challenges(t, proof, n)


def verify(
    t: Transcript,
    G: list,
    H: ref.EdPoint,
    Q: ref.EdPoint,
    a: list,
    P: ref.EdPoint,
    proof: BulletOpeningProof,
) -> bool:
    from ..native import msm_host, ristretto_decode_host

    n = len(a)
    if n == 0 or (n & (n - 1)) or len(G) < n:
        return False
    k = n.bit_length() - 1
    if len(proof.L_vec) != k or len(proof.R_vec) != k:
        return False
    us, e = _fold_challenges(t, proof, n)
    if any(u == 0 for u in us):
        return False

    # a_hat by direct folding; s-vector for G_hat from the challenge bits
    a_f = [v % L_ORDER for v in a]
    for u in us:
        ui = _inv(u)
        h = len(a_f) // 2
        a_f = [(ui * a_f[i] + u * a_f[h + i]) % L_ORDER for i in range(h)]
    a_hat = a_f[0]

    s = []
    uis = [_inv(u) for u in us]
    for i in range(n):
        acc = 1
        for j in range(k):
            bit = (i >> (k - 1 - j)) & 1
            acc = acc * (us[j] if bit else uis[j]) % L_ORDER
        s.append(acc)

    # One combined MSM for the whole check:
    #   z1*(G_hat + a_hat*Q) + z2*H == e*P_star + delta,
    #   P_star = P + sum_j (u_j^2 L_j + u_j^-2 R_j),  G_hat = sum_i s_i G_i
    # rearranged as  e*P_star + delta - z1*B - z2*H == identity.
    delta = ristretto_decode_host(proof.delta)
    if delta is None:
        return False
    z1, z2 = proof.z1 % L_ORDER, proof.z2 % L_ORDER
    check_pts = [P]
    check_scs = [e]
    for j in range(k):
        Lp = ristretto_decode_host(proof.L_vec[j])
        Rp = ristretto_decode_host(proof.R_vec[j])
        if Lp is None or Rp is None:
            return False
        check_pts += [Lp, Rp]
        check_scs += [
            e * (us[j] * us[j] % L_ORDER) % L_ORDER,
            e * (uis[j] * uis[j] % L_ORDER) % L_ORDER,
        ]
    check_pts.append(delta)
    check_scs.append(1)
    for i in range(n):
        check_pts.append(G[i])
        check_scs.append((-(z1 * s[i])) % L_ORDER)
    check_pts.append(Q)
    check_scs.append((-(z1 * a_hat)) % L_ORDER)
    check_pts.append(H)
    check_scs.append((-z2) % L_ORDER)
    acc = msm_host(check_pts, check_scs)
    return acc.ristretto_eq(ref.EdPoint.identity())
