# copied from otti_tpu/spartan/sigma.py
"""Sigma protocols over Pedersen commitments (Spartan's nizk toolbox).

Reconstructs the roles of Spartan's KnowledgeProof / EqualityProof /
ProductProof / DotProductProof (SURVEY.md §3.5: "inner-product/opening
argument", ZK glue for the sumchecks).  All are standard Schnorr-style
proofs over ristretto255 with Merlin Fiat-Shamir; encodings are 32-byte
ristretto points and LE scalars, matching the primitive layer.

Every proof has  prove(transcript, ...) -> Proof  and a matching
verify(transcript, ...) -> bool  that absorbs exactly the same messages.
"""

from __future__ import annotations

import dataclasses

from ..native import msm_host
from ..refimpl import numeric as ref
from ..transcript.merlin import Transcript
from .pedersen_host import BlindSource, Gens, commit, commit_vec, decode

L = ref.L


def _ch(t: Transcript, label: bytes) -> int:
    return t.challenge_scalar(label)


def _ap(t: Transcript, label: bytes, point: ref.EdPoint):
    t.append_point(label, point.ristretto_encode())


def _as(t: Transcript, label: bytes, s: int):
    t.append_scalar(label, (s % L).to_bytes(32, "little"))


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KnowledgeProof:
    alpha: bytes
    z1: int
    z2: int

    @staticmethod
    def prove(t: Transcript, gens: Gens, x: int, r: int, rng: BlindSource):
        t.append_protocol_name(b"knowledge proof")
        C = commit(x, r, gens)
        _ap(t, b"C", C)
        t1, t2 = rng.scalar(), rng.scalar()
        alpha = commit(t1, t2, gens)
        _ap(t, b"alpha", alpha)
        c = _ch(t, b"c")
        return KnowledgeProof(alpha.ristretto_encode(), (x * c + t1) % L, (r * c + t2) % L), C

    def verify(self, t: Transcript, gens: Gens, C: ref.EdPoint) -> bool:
        t.append_protocol_name(b"knowledge proof")
        _ap(t, b"C", C)
        alpha = decode(self.alpha)
        _ap(t, b"alpha", alpha)
        c = _ch(t, b"c")
        lhs = commit(self.z1, self.z2, gens)
        rhs = msm_host([C], [c]) + alpha
        return lhs.ristretto_eq(rhs)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EqualityProof:
    """C1 and C2 commit the same value (C1 - C2 = s*H)."""

    alpha: bytes
    z: int

    @staticmethod
    def prove(t: Transcript, gens: Gens, v: int, r1: int, r2: int, rng: BlindSource):
        t.append_protocol_name(b"equality proof")
        C1, C2 = commit(v, r1, gens), commit(v, r2, gens)
        _ap(t, b"C1", C1)
        _ap(t, b"C2", C2)
        a = rng.scalar()
        alpha = gens.H * a
        _ap(t, b"alpha", alpha)
        c = _ch(t, b"c")
        return EqualityProof(alpha.ristretto_encode(), (c * (r1 - r2) + a) % L), C1, C2

    def verify(self, t: Transcript, gens: Gens, C1: ref.EdPoint, C2: ref.EdPoint) -> bool:
        t.append_protocol_name(b"equality proof")
        _ap(t, b"C1", C1)
        _ap(t, b"C2", C2)
        alpha = decode(self.alpha)
        _ap(t, b"alpha", alpha)
        c = _ch(t, b"c")
        lhs = msm_host([gens.H], [self.z])
        rhs = msm_host([C1 + (-C2)], [c]) + alpha
        return lhs.ristretto_eq(rhs)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ProductProof:
    """C_z commits x*y given C_x, C_y."""

    alpha: bytes
    beta: bytes
    delta: bytes
    z: tuple  # (z1..z5)

    @staticmethod
    def prove(
        t: Transcript,
        gens: Gens,
        x: int,
        rx: int,
        y: int,
        ry: int,
        rz: int,
        rng: BlindSource,
    ):
        t.append_protocol_name(b"product proof")
        z_val = x * y % L
        Cx, Cy, Cz = commit(x, rx, gens), commit(y, ry, gens), commit(z_val, rz, gens)
        for lbl, C in ((b"Cx", Cx), (b"Cy", Cy), (b"Cz", Cz)):
            _ap(t, lbl, C)
        b1, b2, b3, b4, b5 = rng.scalars(5)
        alpha = commit(b1, b2, gens)
        beta = commit(b3, b4, gens)
        delta = msm_host([Cx, gens.H], [b3, b5])
        for lbl, C in ((b"alpha", alpha), (b"beta", beta), (b"delta", delta)):
            _ap(t, lbl, C)
        c = _ch(t, b"c")
        z = (
            (b1 + c * x) % L,
            (b2 + c * rx) % L,
            (b3 + c * y) % L,
            (b4 + c * ry) % L,
            (b5 + c * (rz - rx * y)) % L,
        )
        return (
            ProductProof(
                alpha.ristretto_encode(),
                beta.ristretto_encode(),
                delta.ristretto_encode(),
                z,
            ),
            Cx,
            Cy,
            Cz,
        )

    def verify(
        self,
        t: Transcript,
        gens: Gens,
        Cx: ref.EdPoint,
        Cy: ref.EdPoint,
        Cz: ref.EdPoint,
    ) -> bool:
        t.append_protocol_name(b"product proof")
        for lbl, C in ((b"Cx", Cx), (b"Cy", Cy), (b"Cz", Cz)):
            _ap(t, lbl, C)
        alpha, beta, delta = decode(self.alpha), decode(self.beta), decode(self.delta)
        for lbl, C in ((b"alpha", alpha), (b"beta", beta), (b"delta", delta)):
            _ap(t, lbl, C)
        c = _ch(t, b"c")
        z1, z2, z3, z4, z5 = self.z
        ok1 = (alpha + msm_host([Cx], [c])).ristretto_eq(commit(z1, z2, gens))
        ok2 = (beta + msm_host([Cy], [c])).ristretto_eq(commit(z3, z4, gens))
        ok3 = (delta + msm_host([Cz], [c])).ristretto_eq(
            msm_host([Cx, gens.H], [z3, z5])
        )
        return ok1 and ok2 and ok3


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DualBaseEqualityProof:
    """C1 = v*G + b1*H and C2 = v*Q + b2*H commit the same value under two
    independent scalar bases (AND-composed Schnorr).  Ties the G0-based
    claim commitments to the Q-based commitment the bullet opening needs
    (Q must be independent of the vector generator family)."""

    alpha: bytes
    beta: bytes
    z: int
    z1: int
    z2: int

    @staticmethod
    def prove(
        t: Transcript,
        G: ref.EdPoint,
        Q: ref.EdPoint,
        H: ref.EdPoint,
        v: int,
        b1: int,
        b2: int,
        rng: BlindSource,
    ):
        t.append_protocol_name(b"dual base equality proof")
        C1 = msm_host([G, H], [v % L, b1 % L])
        C2 = msm_host([Q, H], [v % L, b2 % L])
        _ap(t, b"C1", C1)
        _ap(t, b"C2", C2)
        d, s1, s2 = rng.scalars(3)
        alpha = msm_host([G, H], [d, s1])
        beta = msm_host([Q, H], [d, s2])
        _ap(t, b"alpha", alpha)
        _ap(t, b"beta", beta)
        c = _ch(t, b"c")
        return (
            DualBaseEqualityProof(
                alpha.ristretto_encode(),
                beta.ristretto_encode(),
                (d + c * v) % L,
                (s1 + c * b1) % L,
                (s2 + c * b2) % L,
            ),
            C1,
            C2,
        )

    def verify(
        self,
        t: Transcript,
        G: ref.EdPoint,
        Q: ref.EdPoint,
        H: ref.EdPoint,
        C1: ref.EdPoint,
        C2: ref.EdPoint,
    ) -> bool:
        t.append_protocol_name(b"dual base equality proof")
        _ap(t, b"C1", C1)
        _ap(t, b"C2", C2)
        alpha, beta = decode(self.alpha), decode(self.beta)
        _ap(t, b"alpha", alpha)
        _ap(t, b"beta", beta)
        c = _ch(t, b"c")
        ok1 = msm_host([G, H], [self.z, self.z1]).ristretto_eq(
            msm_host([C1], [c]) + alpha
        )
        ok2 = msm_host([Q, H], [self.z, self.z2]).ristretto_eq(
            msm_host([C2], [c]) + beta
        )
        return ok1 and ok2


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DotProductProof:
    """<x, a> = y for committed vector x (C_x) and committed scalar y (C_y),
    public weight vector a.  Linear-size (|x| scalars) — Spartan's
    DotProductProof; the log-size bullet variant can replace it later."""

    delta: bytes
    beta: bytes
    z: list
    z_delta: int
    z_beta: int

    @staticmethod
    def prove(
        t: Transcript,
        gens: Gens,
        x: list,
        rx: int,
        a: list,
        y: int,
        ry: int,
        rng: BlindSource,
    ):
        assert len(x) == len(a) <= gens.n
        t.append_protocol_name(b"dot product proof")
        Cx = commit_vec(x, rx, gens)
        Cy = commit(y, ry, gens)
        _ap(t, b"Cx", Cx)
        _ap(t, b"Cy", Cy)
        for ai in a:
            _as(t, b"a", ai)
        d = rng.scalars(len(x))
        r_delta, r_beta = rng.scalar(), rng.scalar()
        delta = commit_vec(d, r_delta, gens)
        dy = sum(di * ai for di, ai in zip(d, a)) % L
        beta = commit(dy, r_beta, gens)
        _ap(t, b"delta", delta)
        _ap(t, b"beta", beta)
        c = _ch(t, b"c")
        z = [(c * xi + di) % L for xi, di in zip(x, d)]
        return (
            DotProductProof(
                delta.ristretto_encode(),
                beta.ristretto_encode(),
                z,
                (c * rx + r_delta) % L,
                (c * ry + r_beta) % L,
            ),
            Cx,
            Cy,
        )

    def verify(
        self,
        t: Transcript,
        gens: Gens,
        a: list,
        Cx: ref.EdPoint,
        Cy: ref.EdPoint,
    ) -> bool:
        t.append_protocol_name(b"dot product proof")
        _ap(t, b"Cx", Cx)
        _ap(t, b"Cy", Cy)
        for ai in a:
            _as(t, b"a", ai)
        delta, beta = decode(self.delta), decode(self.beta)
        _ap(t, b"delta", delta)
        _ap(t, b"beta", beta)
        c = _ch(t, b"c")
        ok1 = (msm_host([Cx], [c]) + delta).ristretto_eq(
            commit_vec(self.z, self.z_delta, gens)
        )
        za = sum(zi * ai for zi, ai in zip(self.z, a)) % L
        ok2 = (msm_host([Cy], [c]) + beta).ristretto_eq(commit(za, self.z_beta, gens))
        return ok1 and ok2
