"""Device-resident Merlin / STROBE-128 / Keccak-f[1600] transcript (port of
otti_tpu/transcript/device.py).

With a host transcript every sumcheck round costs a device->host fetch of
its evaluations before the challenge can be drawn.  With the transcript on
the device, a prover enqueues every round of both phases, every challenge
and the opening materials without waiting on the card, and fetches the
proof materials at the end.

Byte positions inside the STROBE duplex depend only on the lengths of what
is absorbed and squeezed, and in the Spartan schedule those lengths are
fixed by the instance's shape (labels, 32-byte scalars and points, 64-byte
challenges).  So ``pos`` / ``pos_begin`` / ``cur_flags`` stay Python ints on
the host, and only the 200-byte sponge state is a ``uint8[200]`` tensor on
the device (``[B, 200]`` for B instances of one shape proved side by side,
spartan/batched.py: their offsets are the same).  Every strobe operation is a torch op on that tensor at offsets
known on the host (an XOR, a copy, a zeroing), updating it in place; the
pad and the permutation are kernel K3 (``keccak_f1600_bytes``).  The
constant bytes an operation absorbs (labels, lengths, framing) are uploaded
once per device and cached, so that a warm prove sends nothing from the
host.

Keccak-f[1600]: ``keccak_f1600_cuda`` launches the CUDA kernel of
``csrc/keccak.cu`` (in place, one launch for a batch of states, STROBE's
pad XORed in first when given ``pos >= 0``); ``keccak_f1600_plain`` is the
same function in plain torch on (lo, hi) 32-bit lane halves held in int64,
as the JAX package computes it on uint32 halves (torch on the CPU has no
uint32 ``+`` or ``>>``, nor uint64 shifts).  ``keccak_f1600_bytes`` picks
by device: the kernel for a CUDA tensor, the plain version for a CPU
tensor.

Bit-exactness: mirrors transcript/merlin.py (host) operation for operation;
tests/test_torch_device_transcript.py holds the state after every
operation kind, and a handoff from the host, against the JAX package's
DeviceTranscript and the port's host Merlin copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..field import ops as F
from ..field.fields import SCALAR, int_to_limbs
from .keccak import _RC
from .merlin import FLAG_A, FLAG_C, FLAG_I, FLAG_K, FLAG_M, FLAG_T, Strobe128  # noqa: F401

_RATE = 166  # STROBE-128 rate in bytes
# sponge offsets after every challenge: each ends with run_f (C-flag force)
# and a 64-byte squeeze => pos 64, fresh op frame
POST_CHALLENGE = (64, 0, FLAG_I | FLAG_A | FLAG_C)
U8 = torch.uint8
I64 = torch.int64
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Keccak-f[1600] on (lo, hi) lane halves, flat lane index i = x + 5 * y
# ---------------------------------------------------------------------------

def _pi_tables():
    """rho + pi as a gather: lane ``dst`` of the result is lane src[dst]
    rotated left by rot[dst]."""
    src = np.arange(25)
    rot = np.zeros(25, np.int64)
    x, y = 1, 0
    for t in range(24):
        nx, ny = y, (2 * x + 3 * y) % 5
        src[nx + 5 * ny] = x + 5 * y
        rot[nx + 5 * ny] = ((t + 1) * (t + 2) // 2) % 64
        x, y = nx, ny
    return src, rot


PI_SRC, PI_ROT = _pi_tables()
_LANE_CONSTS: dict = {}  # device -> the plain permutation's index and shift tensors


def _lane_consts(device) -> dict:
    key = str(device)
    c = _LANE_CONSTS.get(key)
    if c is None:
        rot = torch.from_numpy(PI_ROT)
        c = _LANE_CONSTS[key] = {
            "src": torch.from_numpy(PI_SRC).to(device),
            "swap": (rot >= 32).to(device),
            "r": (rot % 32).to(device),
            "rc_lo": torch.tensor([rc & _M32 for rc in _RC], dtype=I64, device=device),
            "rc_hi": torch.tensor([rc >> 32 for rc in _RC], dtype=I64, device=device),
        }
    return c


def _rotl_1(lo, hi):
    return ((lo << 1) | (hi >> 31)) & _M32, ((hi << 1) | (lo >> 31)) & _M32


def keccak_f1600_lanes(lo: torch.Tensor, hi: torch.Tensor):
    """The 24 rounds on int64 lane halves [B, 25], each in [0, 2^32)."""
    c = _lane_consts(lo.device)
    b = lo.shape[0]
    for i in range(24):
        # theta
        a_lo, a_hi = lo.view(b, 5, 5), hi.view(b, 5, 5)  # [B, y, x]
        c_lo = a_lo[:, 0] ^ a_lo[:, 1] ^ a_lo[:, 2] ^ a_lo[:, 3] ^ a_lo[:, 4]
        c_hi = a_hi[:, 0] ^ a_hi[:, 1] ^ a_hi[:, 2] ^ a_hi[:, 3] ^ a_hi[:, 4]
        r_lo, r_hi = _rotl_1(torch.roll(c_lo, -1, 1), torch.roll(c_hi, -1, 1))
        d_lo = torch.roll(c_lo, 1, 1) ^ r_lo
        d_hi = torch.roll(c_hi, 1, 1) ^ r_hi
        lo = (a_lo ^ d_lo[:, None, :]).reshape(b, 25)
        hi = (a_hi ^ d_hi[:, None, :]).reshape(b, 25)
        # rho + pi: a gather and per-lane rotations
        lo, hi = lo[:, c["src"]], hi[:, c["src"]]
        lo1 = torch.where(c["swap"], hi, lo)
        hi1 = torch.where(c["swap"], lo, hi)
        r = c["r"]
        # (x >> (32 - r)) written as ((x >> (31 - r)) >> 1), so that r = 0 is safe
        lo = ((lo1 << r) | ((hi1 >> (31 - r)) >> 1)) & _M32
        hi = ((hi1 << r) | ((lo1 >> (31 - r)) >> 1)) & _M32
        # chi
        b_lo, b_hi = lo.view(b, 5, 5), hi.view(b, 5, 5)
        lo = (b_lo ^ ((torch.roll(b_lo, -1, 2) ^ _M32) & torch.roll(b_lo, -2, 2))).reshape(b, 25)
        hi = (b_hi ^ ((torch.roll(b_hi, -1, 2) ^ _M32) & torch.roll(b_hi, -2, 2))).reshape(b, 25)
        # iota
        lo[:, 0] ^= c["rc_lo"][i]
        hi[:, 0] ^= c["rc_hi"][i]
    return lo, hi


def _bytes_to_lanes(st: torch.Tensor):
    b = st.reshape(-1, 25, 8).to(I64)
    lo = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    hi = b[..., 4] | (b[..., 5] << 8) | (b[..., 6] << 16) | (b[..., 7] << 24)
    return lo, hi


def _lanes_to_bytes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    parts = [lo, lo >> 8, lo >> 16, lo >> 24, hi, hi >> 8, hi >> 16, hi >> 24]
    return (torch.stack(parts, dim=-1) & 0xFF).reshape(lo.shape[0], 200).to(U8)


def keccak_f1600_plain(st: torch.Tensor, pos: int = -1, pos_begin: int = 0) -> torch.Tensor:
    """Keccak-f[1600] of uint8 states [B, 200] (little-endian lanes) ->
    new [B, 200] tensor, in plain torch on any device; with ``pos >= 0``
    STROBE's pad (``_pad_bytes(pos, pos_begin)``) is XORed in first."""
    if pos >= 0:
        st = st ^ _pad_bytes(pos, pos_begin, st.device)
    lo, hi = keccak_f1600_lanes(*_bytes_to_lanes(st))
    return _lanes_to_bytes(lo, hi)


def keccak_f1600_cuda(st: torch.Tensor, pos: int = -1, pos_begin: int = 0) -> torch.Tensor:
    """The same on uint8 states [B, 200] on a CUDA device, IN PLACE, by the
    CUDA kernel (one launch, pad included, one warp a state).  Returns
    ``st``."""
    if st.device.type != "cuda":
        raise ValueError("keccak_f1600_cuda: the states must be on a CUDA device")
    if st.dtype != U8 or st.dim() != 2 or st.shape[1] != 200 or not st.is_contiguous():
        raise ValueError("keccak_f1600_cuda: contiguous uint8 [B, 200] states required")
    if st.data_ptr() % 8:  # lanes are read and written as 8-byte words, in place
        raise ValueError("keccak_f1600_cuda: the states must be 8-byte aligned")
    if not -1 <= pos <= _RATE:
        raise ValueError(f"keccak_f1600_cuda: pad position {pos} outside [-1, {_RATE}]")
    if st.shape[0] == 0:
        return st
    lib = _build.library()
    err = lib.otti_keccak_pad_f1600(st.data_ptr(), st.shape[0], pos, pos_begin,
                                    st.device.index, _build.stream_ptr(st))
    _build.check(err, "keccak_f1600")
    _build.LAUNCHES["keccak_f1600"] += 1
    return st


def keccak_f1600_bytes(st: torch.Tensor, pos: int = -1, pos_begin: int = 0) -> torch.Tensor:
    """Keccak-f[1600] of uint8 states [B, 200] (or one state [200]) in
    place, STROBE's pad first when ``pos >= 0``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  Returns ``st``."""
    flat = st.view(-1, 200)
    if st.device.type == "cuda":
        keccak_f1600_cuda(flat, pos, pos_begin)
    elif st.device.type == "cpu":
        flat.copy_(keccak_f1600_plain(flat, pos, pos_begin))
    else:
        raise ValueError(f"keccak_f1600_bytes: unsupported device {st.device}")
    return st


# ---------------------------------------------------------------------------
# STROBE-128 with byte positions known on the host
# ---------------------------------------------------------------------------

_CONST_BYTES: dict = {}  # (bytes, device) -> uint8 tensor, uploaded once


def _const_bytes(data: bytes, device) -> torch.Tensor:
    key = (bytes(data), str(device))
    t = _CONST_BYTES.get(key)
    if t is None:
        t = _CONST_BYTES[key] = torch.tensor(list(data), dtype=U8, device=device)
    return t


def _pad_bytes(pos: int, pos_begin: int, device) -> torch.Tensor:
    """The 200 bytes of STROBE's pad, XORed into the state before permuting
    (csrc/keccak.cuh::strobe_pad_lane on the card)."""
    pad = bytearray(200)
    pad[pos] ^= pos_begin
    pad[pos + 1] ^= 0x04
    pad[_RATE + 1] ^= 0x80
    return _const_bytes(bytes(pad), device)


def _as_u8(data, device) -> torch.Tensor:
    if isinstance(data, (bytes, bytearray)):
        return _const_bytes(data, device)
    if data.dtype != U8 or data.dim() not in (1, 2):
        raise ValueError("device transcript data: bytes, or a uint8 [n] or [B, n] tensor")
    return data


class DeviceStrobe:
    """STROBE-128 duplex whose state is a uint8[200] tensor, updated in
    place; ``pos`` / ``pos_begin`` / ``cur_flags`` are Python ints.  Mirrors
    transcript/merlin.py Strobe128 operation for operation.

    A state [B, 200] runs B duplexes side by side at the same offsets (B
    instances of one padded shape, each at the post-challenge offsets when
    handed over): what an operation absorbs is [B, n] per instance or
    bytes shared by all, a squeeze returns [B, n], and one K3 launch
    permutes all B states."""

    def __init__(self, protocol_label: bytes = None, device="cpu", _raw=None):
        if _raw is not None:
            self.state, self.pos, self.pos_begin, self.cur_flags = _raw
            return
        # initialisation depends on nothing of the device: run it on the host
        h = Strobe128(protocol_label)
        self.state = torch.tensor(list(h.state), dtype=U8, device=device)
        self.pos, self.pos_begin, self.cur_flags = h.pos, h.pos_begin, h.cur_flags

    @classmethod
    def from_state(cls, state: torch.Tensor, pos: int, pos_begin: int, cur_flags: int):
        """Resume from a state [200] or B states [B, 200] (copied: the strobe
        updates its own in place)."""
        if state.dim() not in (1, 2) or state.shape[-1] != 200:
            raise ValueError(f"strobe state must be [200] or [B, 200], got {tuple(state.shape)}")
        return cls(_raw=(state.to(U8).clone(), int(pos), int(pos_begin), int(cur_flags)))

    @property
    def offsets(self) -> tuple:
        return self.pos, self.pos_begin, self.cur_flags

    # -- internals ----------------------------------------------------------
    def _run_f(self):
        keccak_f1600_bytes(self.state, self.pos, self.pos_begin)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data):
        data = _as_u8(data, self.state.device)
        n, i = data.shape[-1], 0
        while i < n:
            take = min(n - i, _RATE - self.pos)
            self.state[..., self.pos : self.pos + take] ^= data[..., i : i + take]
            self.pos += take
            i += take
            if self.pos == _RATE:
                self._run_f()

    def _overwrite(self, data):
        data = _as_u8(data, self.state.device)
        n, i = data.shape[-1], 0
        while i < n:
            take = min(n - i, _RATE - self.pos)
            self.state[..., self.pos : self.pos + take] = data[..., i : i + take]
            self.pos += take
            i += take
            if self.pos == _RATE:
                self._run_f()

    def _squeeze(self, n: int) -> torch.Tensor:
        outs, got = [], 0
        while got < n:
            take = min(n - got, _RATE - self.pos)
            outs.append(self.state[..., self.pos : self.pos + take].clone())
            self.state[..., self.pos : self.pos + take] = 0
            self.pos += take
            got += take
            if self.pos == _RATE:
                self._run_f()
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "STROBE op continuation mismatch"
            return
        assert flags & FLAG_T == 0, "transport not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    # -- merlin operations ---------------------------------------------------
    def meta_ad(self, data, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> torch.Tensor:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data, more: bool):
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)


# ---------------------------------------------------------------------------
# scalar <-> byte codecs on the device (canonical 12-bit limbs <-> LE bytes)
# ---------------------------------------------------------------------------

def limbs_to_bytes32(c: torch.Tensor) -> torch.Tensor:
    """Canonical limbs [..., 22] (each < 2^12) -> uint8 [..., 32] little-endian."""
    ce, co = c[..., 0::2], c[..., 1::2]  # 11 even and 11 odd limbs = 33 bytes
    b0 = ce & 0xFF
    b1 = (ce >> 8) | ((co & 0xF) << 4)
    b2 = co >> 4
    b = torch.stack([b0, b1, b2], dim=-1).reshape(c.shape[:-1] + (33,))
    return b[..., :32].to(U8)


_POW8_NP = np.stack(
    [np.asarray(int_to_limbs(pow(2, 8 * i, SCALAR.modulus)), np.int64) for i in range(64)]
)  # [64, 22]: limbs of 2^(8 i) mod l
_POW8: dict = {}


def bytes64_to_scalar_limbs(b: torch.Tensor) -> torch.Tensor:
    """64 uniform little-endian bytes [..., 64] -> the canonical scalar (mod
    l) as limbs [..., 22].  value = sum_i b_i 2^(8 i); with POW8[i] = limbs
    of 2^(8 i) mod l the limb sums stay < 64 * 255 * 2^12 < 2^26."""
    key = str(b.device)
    pow8 = _POW8.get(key)
    if pow8 is None:
        pow8 = _POW8[key] = torch.from_numpy(_POW8_NP).to(b.device)
    wide = (b.to(I64)[..., :, None] * pow8).sum(dim=-2)
    return F.canon(SCALAR, F.reduce_wide(SCALAR, wide))


# ---------------------------------------------------------------------------
# Merlin transcript on the device
# ---------------------------------------------------------------------------

def _le32(n: int) -> bytes:
    return n.to_bytes(4, "little")


# copied from otti_tpu/transcript/device.py::export_host_strobe
def export_host_strobe(strobe) -> tuple:
    """(state uint8[200] np array, pos, pos_begin, cur_flags) from either
    the Python Strobe128 or the native C++ NativeStrobe."""
    if hasattr(strobe, "state"):
        return (
            np.frombuffer(bytes(strobe.state), np.uint8).copy(),
            strobe.pos,
            strobe.pos_begin,
            strobe.cur_flags,
        )
    raw = bytes(strobe._buf.raw)  # C layout: u8 st[200]; u8 pos, pos_begin, cur_flags
    return (np.frombuffer(raw[:200], np.uint8).copy(), raw[200], raw[201], raw[202])


class DeviceTranscript:
    """Merlin transcript with the Spartan append/challenge API, on a device.

    Construct fresh with a protocol label, or hand off mid-protocol from a
    host transcript with ``from_host``.  Absorbed scalars must be
    canonical; challenges come back canonical."""

    MERLIN_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes = None, device="cpu", _strobe: DeviceStrobe = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = DeviceStrobe(self.MERLIN_LABEL, device)
        self.append_message(b"dom-sep", label)

    @classmethod
    def from_host(cls, host_transcript, device="cpu", state_dev: torch.Tensor = None):
        """Continue a host Transcript on ``device`` (its state uploaded, or
        ``state_dev`` in its place; the offsets are the host strobe's)."""
        st, pos, pos_begin, cur_flags = export_host_strobe(host_transcript.strobe)
        if state_dev is None:
            state_dev = torch.from_numpy(st).to(device)
        return cls(_strobe=DeviceStrobe.from_state(state_dev, pos, pos_begin, cur_flags))

    @property
    def device(self) -> torch.device:
        return self.strobe.state.device

    def append_message(self, label: bytes, message):
        n = len(message) if isinstance(message, (bytes, bytearray)) else message.shape[-1]
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int):
        self.append_message(label, value.to_bytes(8, "little"))

    def append_scalar_limbs(self, label: bytes, canon_limbs: torch.Tensor):
        """Absorb a canonical limb vector [22] (one a state: [B, 22]) as its
        32-byte LE encoding."""
        self.append_message(label, limbs_to_bytes32(canon_limbs))

    def append_point_bytes(self, label: bytes, enc32):
        self.append_message(label, enc32)

    def challenge_bytes(self, label: bytes, n: int) -> torch.Tensor:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_le32(n), True)
        return self.strobe.prf(n, False)

    def challenge_scalar_limbs(self, label: bytes) -> torch.Tensor:
        """64-byte PRF reduced mod l -> canonical limbs [22] ([B, 22])."""
        return bytes64_to_scalar_limbs(self.challenge_bytes(label, 64))

    def challenge_vector_limbs(self, label: bytes, n: int) -> torch.Tensor:
        """n challenges -> [n, 22] ([B, n, 22])."""
        if n == 0:
            return F.zeros(tuple(self.strobe.state.shape[:-1]) + (0,), self.device)
        return torch.stack([self.challenge_scalar_limbs(label) for _ in range(n)], dim=-2)

    def export(self) -> tuple:
        """(a copy of the state, pos, pos_begin, cur_flags)."""
        s = self.strobe
        return s.state.clone(), s.pos, s.pos_begin, s.cur_flags
