# copied from otti_tpu/transcript/keccak.py
"""Keccak-f[1600] permutation + SHA-3/SHAKE sponges (host side).

The Fiat-Shamir transcript (Merlin/STROBE, see strobe.py) is tiny and
inherently sequential, so it runs on the host exactly as the reference
stack runs it on CPU inside Spartan (SURVEY.md §3.5: "Merlin transcript
threads through everything sequentially").  A C++ fast path lives in
native/; this numpy implementation is the portable fallback and oracle.

Implemented from the FIPS-202 specification.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def _round_constants():
    """Derive the 24 iota constants from the degree-8 LFSR (FIPS-202 §3.2.5)."""
    rcs = []
    r = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) & 0xFF
            if r & 2:
                rc ^= 1 << ((1 << j) - 1)
        rcs.append(rc)
    return rcs


_RC = _round_constants()


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (little-endian lanes)."""
    A = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            off = 8 * (x + 5 * y)
            A[x][y] = int.from_bytes(state[off : off + 8], "little")

    for rnd in range(24):
        # theta
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
        Dv = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x][y] ^= Dv[x]
        # rho + pi via the (1,0) -> (y, 2x+3y) walk (FIPS-202 §3.2.2-3)
        x, y = 1, 0
        current = A[x][y]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            current, A[x][y] = A[x][y], _rotl(current, (t + 1) * (t + 2) // 2)
        # chi
        for yy in range(5):
            row = [A[xx][yy] for xx in range(5)]
            for xx in range(5):
                A[xx][yy] = row[xx] ^ ((~row[(xx + 1) % 5]) & row[(xx + 2) % 5] & _MASK)
        # iota
        A[0][0] ^= _RC[rnd]

    for x in range(5):
        for y in range(5):
            off = 8 * (x + 5 * y)
            state[off : off + 8] = A[x][y].to_bytes(8, "little")


class _Sponge:
    def __init__(self, rate: int, suffix: int):
        self.rate = rate
        self.suffix = suffix
        self.state = bytearray(200)
        self.buf = bytearray()
        self.squeezing = False
        self.pos = 0

    def update(self, data: bytes) -> "_Sponge":
        assert not self.squeezing
        self.buf += data
        while len(self.buf) >= self.rate:
            block, self.buf = self.buf[: self.rate], self.buf[self.rate :]
            for i, b in enumerate(block):
                self.state[i] ^= b
            keccak_f1600(self.state)
        return self

    def _pad(self):
        for i, b in enumerate(self.buf):
            self.state[i] ^= b
        self.state[len(self.buf)] ^= self.suffix
        self.state[self.rate - 1] ^= 0x80
        keccak_f1600(self.state)
        self.squeezing = True
        self.pos = 0

    def squeeze(self, n: int) -> bytes:
        if not self.squeezing:
            self._pad()
        out = bytearray()
        while len(out) < n:
            if self.pos == self.rate:
                keccak_f1600(self.state)
                self.pos = 0
            take = min(n - len(out), self.rate - self.pos)
            out += self.state[self.pos : self.pos + take]
            self.pos += take
        return bytes(out)


def sha3_256(data: bytes) -> bytes:
    return _Sponge(136, 0x06).update(data).squeeze(32)


def sha3_512(data: bytes) -> bytes:
    return _Sponge(72, 0x06).update(data).squeeze(64)


def shake256(data: bytes, n: int) -> bytes:
    return _Sponge(136, 0x1F).update(data).squeeze(n)
