# copied from otti_tpu/transcript/merlin.py
"""Merlin transcripts over STROBE-128 (keccak-f[1600]) — host side.

Bit-compatible reimplementation of the `merlin` crate's transcript
construction used by the reference's Spartan prover/verifier (SURVEY.md
§2.2 Spartan row: "Fiat-Shamir via Merlin transcripts").  Implemented from
the public STROBE v1.0.2 specification and the Merlin protocol description;
validated against the published merlin test vector in tests/test_transcript.py.

STROBE-128 parameters: keccak-f[1600], security 128 => rate R = 166 bytes.
Merlin only uses the meta-AD / AD / PRF operations (no transport), which is
all we implement.
"""

from __future__ import annotations

from .keccak import keccak_f1600

_R = 166  # STROBE-128 sponge rate in bytes

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 12 * 8])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals ---------------------------------------------------------
    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "STROBE op continuation mismatch"
            return
        assert flags & FLAG_T == 0, "transport not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = 0 != (flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- operations used by merlin ----------------------------------------
    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(FLAG_A | FLAG_C, more)
        # overwrite mode
        for b in data:
            self.state[self.pos] = b
            self.pos += 1
            if self.pos == _R:
                self._run_f()


def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


def _strobe_factory(label: bytes):
    """Native STROBE when the host library is built; Python otherwise."""
    try:
        from .. import native

        if native.HAVE_NATIVE:
            return native.NativeStrobe(label)
    except Exception:  # pragma: no cover
        pass
    return Strobe128(label)


def transcript_from_strobe_state(
    state_bytes: bytes, pos: int, pos_begin: int, cur_flags: int
) -> "Transcript":
    """Resume a host Transcript from an exported sponge state (the inverse
    of device.export_host_strobe): lets a host tail continue a transcript
    the fused device prover advanced.  Always pure-Python Strobe128 — byte-
    identical to the native strobe."""
    t = Transcript.__new__(Transcript)
    s = Strobe128.__new__(Strobe128)
    s.state = bytearray(state_bytes)
    s.pos = pos
    s.pos_begin = pos_begin
    s.cur_flags = cur_flags
    t.strobe = s
    return t


class Transcript:
    """Merlin transcript with the Spartan-flavoured append/challenge API."""

    MERLIN_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = _strobe_factory(self.MERLIN_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(8), True)
        self.strobe.ad(value.to_bytes(8, "little"), False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)

    # -- Spartan conventions (reconstructed; SURVEY.md §3.5) ---------------
    def append_protocol_name(self, name: bytes):
        self.append_message(b"protocol-name", name)

    def append_scalar(self, label: bytes, scalar_bytes32: bytes):
        assert len(scalar_bytes32) == 32
        self.append_message(label, scalar_bytes32)

    def append_point(self, label: bytes, point_bytes32: bytes):
        assert len(point_bytes32) == 32
        self.append_message(label, point_bytes32)

    def challenge_scalar_bytes(self, label: bytes) -> bytes:
        """64 uniform bytes, to be reduced mod the group order."""
        return self.challenge_bytes(label, 64)

    def challenge_scalar(self, label: bytes) -> int:
        from ..refimpl.numeric import L

        return int.from_bytes(self.challenge_scalar_bytes(label), "little") % L

    def challenge_vector(self, label: bytes, n: int) -> list:
        return [self.challenge_scalar(label) for _ in range(n)]
