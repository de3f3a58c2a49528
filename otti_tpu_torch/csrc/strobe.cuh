// STROBE-128 and Merlin over a 200-byte state, as one warp of a kernel runs
// them (kernel 5's fused round, csrc/custom_round.cu), and the reduction of a
// 64-byte challenge mod l.
//
// Mirrors otti_tpu_torch/transcript/device.py DeviceStrobe (and so
// transcript/merlin.py Strobe128) operation for operation: begin_op,
// absorb, squeeze and run_f (STROBE's pad, then keccak.cuh's rounds), and
// Merlin's append_message and challenge_bytes.  The offsets pos, pos_begin
// and cur_flags are plain ints that every lane holds alike (they depend on
// lengths only); the state lies in memory the lanes share, 8-byte aligned.
//
// Written once over a "strobe warp" model W, as keccak.cuh's rounds are
// over its warp model:
//   w.lane, W::STEP             the byte loops run j = lane, lane + STEP, ...
//   w.sync()                    the lanes' byte writes are seen by all after it
//   w.permute(st, pos, pos_begin)  run_f's pad and Keccak-f[1600], in place
// Compiled by nvcc, W is a warp (32 lanes, shuffles); compiled for the host
// (csrc/host_check.cpp), one lane and keccak.cuh's host warp model, so a CPU
// test holds this very code against the host Merlin and DeviceTranscript.
#pragma once

#include "field.cuh"
#include "keccak.cuh"

enum {
  STROBE_FLAG_I = 1,
  STROBE_FLAG_A = 2,
  STROBE_FLAG_C = 4,
  STROBE_FLAG_K = 32,
  STROBE_FLAG_M = 16
};

struct Strobe {
  uint8_t* st;  // 200 bytes
  int pos, pos_begin, cur_flags;
};

#ifdef __CUDACC__
// The card's model: this thread is lane `lane` of a whole warp.
struct StrobeWarp {
  static const int STEP = 32;
  KeccakWarp kw;
  int lane;
  __device__ explicit StrobeWarp(int lane_) : lane(lane_) {
    kw.t = lane < KECCAK_LANES ? lane : 0;
    kw.src = keccak_sources(kw.t);
  }
  __device__ void sync() const { __syncwarp(); }
  // Not inlined: one copy of the 24 unrolled rounds serves every call site
  // (a round's step has a dozen), so the one warp that runs the step does
  // not stream a fresh copy through the instruction cache each time.
  __device__ __noinline__ void permute(uint8_t* st, int pos, int pos_begin) const {
    uint64_t* lanes = reinterpret_cast<uint64_t*>(st);
    const uint64_t a = keccak_rounds(kw, lanes[kw.t] ^ strobe_pad_lane(kw.t, pos, pos_begin));
    __syncwarp();  // every lane has read its lane before any writes
    if (lane < KECCAK_LANES) lanes[lane] = a;
    __syncwarp();
  }
};
#else
// The host's model: one lane does every byte; the permutation steps the
// 32 lanes of keccak.cuh's host warp model together.
struct StrobeWarp {
  static const int STEP = 1;
  KeccakWarp kw;
  int lane = 0;
  void sync() const {}
  void permute(uint8_t* st, int pos, int pos_begin) const {
    uint64_t lanes[KECCAK_LANES];
    memcpy(lanes, st, sizeof(lanes));
    KeccakLanes a;
    for (int l = 0; l < 32; ++l) a.l[l] = lanes[kw.t[l]] ^ strobe_pad_lane(kw.t[l], pos, pos_begin);
    a = keccak_rounds(kw, a);
    memcpy(st, a.l, sizeof(lanes));
  }
};
#endif

template <class W>
OTTI_FN void strobe_run_f(const W& w, Strobe& s) {
  w.permute(s.st, s.pos, s.pos_begin);
  s.pos = 0;
  s.pos_begin = 0;
}

// squeeze == 0: XOR n bytes of data into the state (absorb); otherwise
// copy n bytes of the state to data and zero them (squeeze).  run_f each
// time the rate fills.
template <class W>
OTTI_FN void strobe_duplex(const W& w, Strobe& s, uint8_t* data, int n, bool squeeze) {
  for (int i = 0; i < n;) {
    const int room = STROBE_RATE - s.pos, take = n - i < room ? n - i : room;
    for (int j = w.lane; j < take; j += W::STEP) {
      uint8_t* b = s.st + s.pos + j;
      if (squeeze) {
        data[i + j] = *b;
        *b = 0;
      } else {
        *b ^= data[i + j];
      }
    }
    w.sync();
    s.pos += take;
    i += take;
    if (s.pos == STROBE_RATE) strobe_run_f(w, s);
  }
}

template <class W>
OTTI_FN void strobe_absorb(const W& w, Strobe& s, const uint8_t* data, int n) {
  strobe_duplex(w, s, const_cast<uint8_t*>(data), n, false);
}

template <class W>
OTTI_FN void strobe_begin_op(const W& w, Strobe& s, int flags) {
  const uint8_t head[2] = {(uint8_t)s.pos_begin, (uint8_t)flags};
  s.pos_begin = s.pos + 1;
  s.cur_flags = flags;
  strobe_absorb(w, s, head, 2);
  if ((flags & (STROBE_FLAG_C | STROBE_FLAG_K)) && s.pos != 0) strobe_run_f(w, s);
}

// meta_ad(label), meta_ad(le32(n), more=True): the frame of a Merlin op.
template <class W>
OTTI_FN void merlin_frame(const W& w, Strobe& s, const uint8_t* label, int llen, int n) {
  strobe_begin_op(w, s, STROBE_FLAG_M | STROBE_FLAG_A);
  strobe_absorb(w, s, label, llen);
  const uint8_t le[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16), (uint8_t)(n >> 24)};
  strobe_absorb(w, s, le, 4);
}

template <class W>
OTTI_FN void merlin_append(const W& w, Strobe& s, const uint8_t* label, int llen,
                           const uint8_t* msg, int mlen) {
  merlin_frame(w, s, label, llen, mlen);
  strobe_begin_op(w, s, STROBE_FLAG_A);
  strobe_absorb(w, s, msg, mlen);
}

template <class W>
OTTI_FN void merlin_challenge(const W& w, Strobe& s, const uint8_t* label, int llen,
                              uint8_t* out, int n) {
  merlin_frame(w, s, label, llen, n);
  strobe_begin_op(w, s, STROBE_FLAG_I | STROBE_FLAG_A | STROBE_FLAG_C);
  strobe_duplex(w, s, out, n, true);
}

// A sumcheck round's transcript step: append_message(label_p, the 32 bytes
// of value p) for each evaluation p, then challenge_bytes(label_r, 64) into
// out64.  prog holds the labels as custom_kernels.round_program builds
// them: byte 0 the count m (the evaluations and the challenge), bytes
// 1..m their lengths, then the labels one after another.
template <class W>
OTTI_FN void merlin_round(const W& w, Strobe& s, const uint8_t* prog, const uint8_t* values32,
                          uint8_t* out64) {
  const int m = prog[0];
  const uint8_t* label = prog + 1 + m;
  for (int p = 0; p + 1 < m; ++p) {
    merlin_append(w, s, label, prog[1 + p], values32 + 32 * p, 32);
    label += prog[1 + p];
  }
  merlin_challenge(w, s, label, prog[m], out64, 64);
}

// 64 little-endian bytes -> their value mod l, canonical: lo + 2^256 hi ==
// lo + hi * (2^256 mod l), one multiply (transcript/device.py's
// bytes64_to_scalar_limbs).
OTTI_FN Fe scalar_from_le64(const uint8_t* b) {
  Fe lo, hi;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) {
    const uint8_t* p = b + 4 * w;
    lo.w[w] = p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
    p += 32;
    hi.w[w] = p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
  }
  const uint32_t two256[9] = {0, 0, 0, 0, 0, 0, 0, 0, 1};
  const Fe r256 = scalar_canon9(two256);
  return fe_add<FIELD_SCALAR>(fe_canon<FIELD_SCALAR>(lo), fe_mul<FIELD_SCALAR>(hi, r256));
}
