"""Merlin transcripts over STROBE-128 in plain Python, for the reference
verifier.

Written from FIPS 202 (Keccak-f[1600]), the STROBE v1.0.2 specification
(the meta-AD, AD and PRF operations, security 128, rate 166 bytes) and the
Merlin transcript construction.  Scalars are 32 little-endian bytes; a
challenge scalar is 64 squeezed bytes reduced mod the group order.
"""

from __future__ import annotations

from .curve import L

_MASK = (1 << 64) - 1
_RATE = 166
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61], [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]  # _ROT[x][y]


def _round_constants() -> list:
    out, r = [], 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            r = ((r << 1) ^ ((r >> 7) * 0x71)) & 0xFF
            if r & 2:
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return out


_RC = _round_constants()


def keccak_f1600(state: bytearray) -> None:
    """In place, on 200 bytes of 25 little-endian lanes, lane (x, y) at 8 (x + 5 y)."""
    a = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        for x in range(5):
            d = c[x - 1] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63)) & _MASK)
            for y in range(0, 25, 5):
                a[x + y] ^= d
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                v, n = a[x + 5 * y], _ROT[x][y]
                b[y + 5 * ((2 * x + 3 * y) % 5)] = ((v << n) | (v >> (64 - n))) & _MASK if n else v
        for y in range(0, 25, 5):
            row = b[y: y + 5]
            for x in range(5):
                a[x + y] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5] & _MASK)
        a[0] ^= rc
    state[:] = b"".join(v.to_bytes(8, "little") for v in a)


class _Strobe:
    """STROBE-128, the operations Merlin uses."""

    _A, _C, _I, _M = 2, 4, 1, 16

    def __init__(self, label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _RATE + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.st, self.pos, self.begin, self.flags = st, 0, 0, 0
        self.meta_ad(label, False)

    def _run_f(self):
        self.st[self.pos] ^= self.begin
        self.st[self.pos + 1] ^= 0x04
        self.st[_RATE + 1] ^= 0x80
        keccak_f1600(self.st)
        self.pos = self.begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.st[self.pos] ^= byte
            self.pos += 1
            if self.pos == _RATE:
                self._run_f()

    def _op(self, flags: int, more: bool):
        if more:
            if flags != self.flags:
                raise ValueError("STROBE continuation of another operation")
            return
        old, self.begin, self.flags = self.begin, self.pos + 1, flags
        self._absorb(bytes([old, flags]))
        if flags & self._C and self.pos:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._op(self._M | self._A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._op(self._A, more)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._op(self._I | self._A | self._C, False)
        out = bytearray(n)
        for i in range(n):
            out[i] = self.st[self.pos]
            self.st[self.pos] = 0
            self.pos += 1
            if self.pos == _RATE:
                self._run_f()
        return bytes(out)


class Transcript:
    def __init__(self, label: bytes):
        self.s = _Strobe(b"Merlin v1.0")
        self.message(b"dom-sep", label)

    def message(self, label: bytes, data: bytes):
        self.s.meta_ad(label, False)
        self.s.meta_ad(len(data).to_bytes(4, "little"), True)
        self.s.ad(data, False)

    def u64(self, label: bytes, value: int):
        self.message(label, value.to_bytes(8, "little"))

    def scalar(self, label: bytes, x: int):
        self.message(label, (x % L).to_bytes(32, "little"))

    def protocol(self, name: bytes):
        self.message(b"protocol-name", name)

    def challenge(self, label: bytes) -> int:
        self.s.meta_ad(label, False)
        self.s.meta_ad((64).to_bytes(4, "little"), True)
        return int.from_bytes(self.s.prf(64), "little") % L
