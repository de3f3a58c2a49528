// Keccak-f[1600] on one warp a state, lane t < 25 holding state lane t, and
// the STROBE pad that the device transcript XORs in before each permutation.
//
// State lane i = x + 5 y is bytes 8i..8i+7 of the 200-byte state,
// little-endian.  A round is four exchanges of lanes by shuffles, each
// followed by a few operations on the thread's own 64-bit lane:
//   theta  the column parity C[x] from the four other lanes of the column,
//          then C[x - 1] ^ rotl(C[x + 1], 1) from the column's neighbours;
//   rho+pi lane t takes lane PI_SRC[t] and rotates it by PI_ROT[t];
//   chi    lane t takes its row's next two lanes: b ^ (~b1 & b2);
//   iota   lane 0 XORs the round constant.
// A rotation is two funnel shifts of the 32-bit halves; ptxas folds the
// XORs and chi into 3-input LOP3 operations.  Lanes 25..31 shadow lane 0.
//
// The rounds are written once, generic in a "warp model" W: compiled by
// nvcc, W is the thread's own lane with __shfl_sync; compiled for the host
// (csrc/host_check.cpp) W steps all 32 lanes together, each shuffle a gather, so a
// CPU test holds the very rounds the kernel runs against the host library
// and the plain torch permutation.
#pragma once

#include <stdint.h>

#ifndef OTTI_FN
#ifdef __CUDACC__
#define OTTI_FN __device__ __forceinline__
#define OTTI_CONST static __constant__
#else
#define OTTI_FN static inline
#define OTTI_CONST static
#endif
#endif

#define KECCAK_LANES 25
#define STROBE_RATE 166  // bytes; the pad's last byte is at STROBE_RATE + 1

// The round constants of FIPS 202 (transcript/keccak.py's _RC), and rho + pi
// as a gather (transcript/device.py's PI_SRC, PI_ROT): lane t of the result
// is lane KECCAK_PI_SRC[t] rotated left by KECCAK_PI_ROT[t].  A CPU test
// holds the three tables equal to the plain version's.
OTTI_CONST uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
OTTI_CONST int KECCAK_PI_SRC[KECCAK_LANES] = {0,  6,  12, 18, 24, 3, 9,  10, 16, 22, 1,  7, 13,
                                              19, 20, 4,  5,  11, 17, 23, 2, 8,  14, 15, 21};
OTTI_CONST int KECCAK_PI_ROT[KECCAK_LANES] = {0,  44, 43, 21, 14, 28, 20, 3,  45, 61, 1,  6, 25,
                                              8,  18, 27, 36, 10, 15, 56, 62, 55, 39, 41, 2};

// v rotated left by n bits, 0 <= n < 64.
OTTI_FN uint64_t rotl64(uint64_t v, int n) {
#ifdef __CUDA_ARCH__
  uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  if (n & 32) {  // swap the halves, then rotate by n - 32
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  const uint32_t rhi = __funnelshift_l(lo, hi, n & 31), rlo = __funnelshift_l(hi, lo, n & 31);
  return ((uint64_t)rhi << 32) | rlo;
#else
  return (v << (n & 63)) | (v >> ((64 - n) & 63));
#endif
}

// Which lane each step of a round reads, for lane t (t < 25).
enum {
  KS_COL = 0,  // theta, 0..3: the other four lanes of t's column
  KS_CM1 = 4,  // theta: a lane of column x - 1
  KS_CP1 = 5,  // theta: a lane of column x + 1
  KS_PI = 6,   // rho + pi
  KS_N1 = 7,   // chi: the next two lanes of t's row
  KS_N2 = 8,
  KS_N = 9
};

struct KeccakSources {
  int idx[KS_N];
  int rot;  // rho: the rotation of the lane taken at KS_PI
};

OTTI_FN KeccakSources keccak_sources(int t) {
  const int x = t % 5, y = t / 5;
  KeccakSources s;
  for (int k = 0; k < 4; ++k) s.idx[KS_COL + k] = x + 5 * ((y + 1 + k) % 5);
  s.idx[KS_CM1] = (x + 4) % 5;
  s.idx[KS_CP1] = (x + 1) % 5;
  s.idx[KS_PI] = KECCAK_PI_SRC[t];
  s.idx[KS_N1] = 5 * y + (x + 1) % 5;
  s.idx[KS_N2] = 5 * y + (x + 2) % 5;
  s.rot = KECCAK_PI_ROT[t];
  return s;
}

// The 24 rounds on one lane value a per lane, in a warp model W:
//   W::V          a lane's 64-bit value (one per lane),
//   w.shfl(v, k)  each lane reads v from the lane its source k names,
//   w.rotl(v, n)  rotation by n; w.rho(v) by each lane's rho offset,
//   w.iota(v, r)  lane 0 XORs round constant r,
// and ^, &, ~ act lane by lane.
template <class W>
OTTI_FN typename W::V keccak_rounds(const W& w, typename W::V a) {
  typedef typename W::V V;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    const V c = a ^ w.shfl(a, KS_COL) ^ w.shfl(a, KS_COL + 1) ^ w.shfl(a, KS_COL + 2) ^
                w.shfl(a, KS_COL + 3);
    a = a ^ w.shfl(c, KS_CM1) ^ w.rotl(w.shfl(c, KS_CP1), 1);
    const V b = w.rho(w.shfl(a, KS_PI));
    a = b ^ (~w.shfl(b, KS_N1) & w.shfl(b, KS_N2));
    a = w.iota(a, r);
  }
  return a;
}

// STROBE's pad before a permutation (transcript/merlin.py Strobe128._run_f),
// lane t's share: pos_begin at byte pos, 0x04 at byte pos + 1, 0x80 at byte
// STROBE_RATE + 1.  pos < 0: no pad; otherwise pos lies in [0, STROBE_RATE].
OTTI_FN uint64_t strobe_pad_lane(int t, int pos, int pos_begin) {
  if (pos < 0) return 0;
  uint64_t m = 0;
  if (t == pos >> 3) m ^= (uint64_t)(pos_begin & 0xFF) << (8 * (pos & 7));
  if (t == (pos + 1) >> 3) m ^= 0x04ull << (8 * ((pos + 1) & 7));
  if (t == (STROBE_RATE + 1) / 8) m ^= 0x80ull << (8 * ((STROBE_RATE + 1) % 8));
  return m;
}

#ifdef __CUDACC__
// The device's warp model: this thread's lane t (lanes 25..31: t = 0), its
// sources in registers.
struct KeccakWarp {
  typedef uint64_t V;
  KeccakSources src;
  int t;
  __device__ __forceinline__ V shfl(V v, int k) const {
    return __shfl_sync(0xFFFFFFFFu, v, src.idx[k]);
  }
  __device__ __forceinline__ V rotl(V v, int n) const { return rotl64(v, n); }
  __device__ __forceinline__ V rho(V v) const { return rotl64(v, src.rot); }
  __device__ __forceinline__ V iota(V v, int r) const { return t == 0 ? v ^ KECCAK_RC[r] : v; }
};
#else
// The host's warp model: all 32 lanes stepped together (lanes 25..31
// shadow lane 0, as on the device).
struct KeccakLanes {
  uint64_t l[32];
  KeccakLanes operator^(const KeccakLanes& o) const {
    KeccakLanes r;
    for (int i = 0; i < 32; ++i) r.l[i] = l[i] ^ o.l[i];
    return r;
  }
  KeccakLanes operator&(const KeccakLanes& o) const {
    KeccakLanes r;
    for (int i = 0; i < 32; ++i) r.l[i] = l[i] & o.l[i];
    return r;
  }
  KeccakLanes operator~() const {
    KeccakLanes r;
    for (int i = 0; i < 32; ++i) r.l[i] = ~l[i];
    return r;
  }
};

struct KeccakWarp {
  typedef KeccakLanes V;
  KeccakSources src[32];
  int t[32];
  KeccakWarp() {
    for (int i = 0; i < 32; ++i) {
      t[i] = i < KECCAK_LANES ? i : 0;
      src[i] = keccak_sources(t[i]);
    }
  }
  V shfl(const V& v, int k) const {
    V r;
    for (int i = 0; i < 32; ++i) r.l[i] = v.l[src[i].idx[k]];
    return r;
  }
  V rotl(const V& v, int n) const {
    V r;
    for (int i = 0; i < 32; ++i) r.l[i] = rotl64(v.l[i], n);
    return r;
  }
  V rho(const V& v) const {
    V r;
    for (int i = 0; i < 32; ++i) r.l[i] = rotl64(v.l[i], src[i].rot);
    return r;
  }
  V iota(V v, int r) const {
    for (int i = 0; i < 32; ++i)
      if (t[i] == 0) v.l[i] ^= KECCAK_RC[r];
    return v;
  }
};
#endif
