# copied from otti_tpu/spartan/pedersen_host.py
"""Host-side Pedersen commitment arithmetic for the sigma protocols.

The ZK layer's per-round commitments and sigma proofs involve O(log n)
single-point group operations — latency-bound, not throughput-bound — so
they run on the host big-int reference implementation while all bulk MSMs
stay on device (SURVEY.md §5.8: host/device boundary discipline).
"""

from __future__ import annotations

from ..refimpl import numeric as ref
from ..transcript.keccak import shake256
from .commitments import gen_points_host

L = ref.L


class Gens:
    """n vector generators + blinding generator (host EdPoints)."""

    def __init__(self, n: int, label: bytes):
        self.n = n
        self.G, self.H = gen_points_host(n, label)

    def sub(self, n: int) -> "Gens":
        g = object.__new__(Gens)
        g.n = n
        g.G, g.H = self.G[:n], self.H
        return g


def commit(value: int, blind: int, gens: Gens) -> ref.EdPoint:
    """value * G_0 + blind * H."""
    from ..native import msm_host

    return msm_host([gens.G[0], gens.H], [value % L, blind % L])


def commit_vec(values, blind: int, gens: Gens) -> ref.EdPoint:
    from ..native import msm_host

    vals = [v % L for v in values]
    return msm_host(list(gens.G[: len(vals)]) + [gens.H], vals + [blind % L])


class BlindSource:
    """Deterministic prover randomness: shake256(seed || counter).

    One seed per proof (callers pass os.urandom(32) by default); never
    reused across transcript positions.  Uses hashlib's C SHAKE-256 — a
    zk proof draws hundreds of blinds and the pure-Python sponge cost
    ~0.3 s per proof (r03 profile).
    """

    def __init__(self, seed: bytes):
        self.seed = seed
        self.ctr = 0

    def scalar(self) -> int:
        import hashlib

        h = hashlib.shake_256(self.seed + self.ctr.to_bytes(8, "little"))
        self.ctr += 1
        return int.from_bytes(h.digest(64), "little") % L

    def scalars(self, n: int) -> list:
        return [self.scalar() for _ in range(n)]


def decode(b: bytes) -> ref.EdPoint:
    p = ref.EdPoint.ristretto_decode(b)
    if p is None:
        raise ValueError("invalid ristretto point encoding")
    return p
