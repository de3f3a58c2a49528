// Per-thread arithmetic mod l = 2^252 + c (SCALAR) and p = 2^255 - 19 (BASE)
// on eight 32-bit machine words held in registers.
//
// Storage stays what the Python package uses everywhere: 22 little-endian
// 12-bit limbs in int32 (otti_tpu_torch/field/fields.py), in any "semi" form
// of otti_tpu_torch/field/ops.py (a limb may be -1 or exceed 2^12).  fe_pack
// carries such a row exactly and packs it into an Fe (8 words); fe_unpack
// writes a canonical Fe back as 22 limbs in [0, 2^12).  In between, a
// product is 64 32x32->64 multiplies in carry chains and a reduction that
// uses the shape of the modulus instead of a fold matrix:
//   BASE:   2^256 = 38 and 2^255 = 19 (mod p);
//   SCALAR: 2^252 = -c (mod l), c of 125 bits, folded twice on the product
//           and once more on the (small) rest, a multiple of l added first
//           so that no intermediate goes negative.
//
// Contract of fe_pack: the row's value sum(limb_i * 2^(12 i)) lies in
// [0, 2^256) and |limb_i| < 2^18.  Every semi form qualifies (< 2^253 for
// SCALAR, < 2^256 for BASE).  fe_mul takes any two such values and returns
// the canonical product; fe_add / fe_sub take and return canonical values.
//
// The modulus constants (words of m, of the tail c or 19, and 38) live in
// constant memory and are copied in once from the Python field specs
// (otti_tpu_torch/_build.py::field_consts), so the numbers have one source:
// otti_tpu_torch/field/fields.py.
//
// The arithmetic is plain C++ on uint32_t/uint64_t, so the same header also
// compiles for the host (csrc/host_check.cpp), where a CPU test holds it
// against Python integers.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define OTTI_FN __device__ __forceinline__
#define OTTI_CONST static __constant__
#else
#include <string.h>
#define OTTI_FN static inline
#define OTTI_CONST static
#endif

#define OTTI_NL 22        // limbs per stored element
#define OTTI_LM 0xFFF     // limb mask
#define OTTI_NW 8         // 32-bit words per element in registers

enum { FIELD_SCALAR = 0, FIELD_BASE = 1 };

struct FieldConsts {
  uint32_t mod[OTTI_NW];  // words of m
  uint32_t tail[4];       // SCALAR: c = l - 2^252; BASE: 19 = 2^255 mod p
  uint32_t fold;          // BASE: 38 = 2^256 mod p; SCALAR: unused (0)
};

// static: each translation unit owns its copy and sets it in its own init.
OTTI_CONST FieldConsts FC[2];

static int set_field_consts(const int32_t* host) {
#ifdef __CUDACC__
  return (int)cudaMemcpyToSymbol(FC, host, sizeof(FieldConsts) * 2);
#else
  memcpy(FC, host, sizeof(FieldConsts) * 2);
  return 0;
#endif
}

// One field element: value = sum(w[i] * 2^(32 i)).
struct Fe {
  uint32_t w[OTTI_NW];
};

// ---------------------------------------------------------------------------
// multi-word helpers (fully unrolled: every index is a compile-time constant)
// ---------------------------------------------------------------------------

// x[0..N) += y[0..M), M <= N; returns the carry out of word N-1.
template <int N, int M>
OTTI_FN uint32_t add_words(uint32_t* x, const uint32_t* y) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)x[i] + (i < M ? y[i] : 0u);
    x[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// x[0..N) -= y[0..M), M <= N; returns 1 if the result went below zero.
template <int N, int M>
OTTI_FN uint32_t sub_words(uint32_t* x, const uint32_t* y) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t t = (uint64_t)x[i] - (i < M ? y[i] : 0u) - borrow;
    x[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// r[0..NA+NB) = a[0..NA) * b[0..NB): schoolbook rows, each a carry chain of
// 32x32->64 multiply-adds (a*b + r + carry <= 2^64 - 1, no overflow).
template <int NA, int NB>
OTTI_FN void mul_words(const uint32_t* a, const uint32_t* b, uint32_t* r) {
#pragma unroll
  for (int k = 0; k < NB; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint64_t t = (uint64_t)a[i] * b[j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    r[i + NB] = (uint32_t)carry;
  }
}

// out[0..N) = (x >> 252)[0..N) for a value x of NX words (words past NX
// read as zero).  Bit 252 is bit 28 of word 7.
template <int N, int NX>
OTTI_FN void shr252(const uint32_t* x, uint32_t* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t lo = 7 + i < NX ? x[7 + i] : 0u;
    const uint32_t hi = 8 + i < NX ? x[8 + i] : 0u;
    out[i] = (lo >> 28) | (hi << 4);
  }
}

// x <- x - m if that is non-negative.
template <int F>
OTTI_FN void cond_sub(Fe& x) {
  Fe d = x;
  const uint32_t below = sub_words<OTTI_NW, OTTI_NW>(d.w, FC[F].mod);
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) x.w[i] = below ? x.w[i] : d.w[i];
}

// ---------------------------------------------------------------------------
// canonicalisation
// ---------------------------------------------------------------------------

// SCALAR: a 9-word value r < 2^284 (r[8] < 2^28) -> canonical.
//   r = r0 + 2^252 h  ==  r0 + l - c*h  (mod l), which lies in (0, 2l)
//   because r0 < 2^252 < l and c*h < 2^157 < l.
OTTI_FN Fe scalar_canon9(const uint32_t* r) {
  const uint32_t h = (r[7] >> 28) | (r[8] << 4);
  uint32_t u[5];
  mul_words<4, 1>(FC[FIELD_SCALAR].tail, &h, u);
  Fe x;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) x.w[i] = r[i];
  x.w[7] &= 0x0FFFFFFFu;
  add_words<OTTI_NW, OTTI_NW>(x.w, FC[FIELD_SCALAR].mod);
  sub_words<OTTI_NW, 5>(x.w, u);
  cond_sub<FIELD_SCALAR>(x);
  return x;
}

// BASE: any 8-word value -> canonical.  Fold bit 255 (2^255 = 19), which
// leaves v < 2^255 + 19 < 2p, then subtract p once if v >= p: v - p =
// v + 19 - 2^255, so v >= p exactly when v + 19 reaches bit 255.
OTTI_FN Fe base_canon8(Fe x) {
  const uint32_t nineteen = FC[FIELD_BASE].tail[0];
  uint32_t t = nineteen * (x.w[7] >> 31);
  x.w[7] &= 0x7FFFFFFFu;
  add_words<OTTI_NW, 1>(x.w, &t);
  Fe y = x;
  add_words<OTTI_NW, 1>(y.w, &nineteen);
  const bool ge = (y.w[7] >> 31) != 0;
  y.w[7] &= 0x7FFFFFFFu;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) x.w[i] = ge ? y.w[i] : x.w[i];
  return x;
}

// Any value in [0, 2^256) -> canonical.
template <int F>
OTTI_FN Fe fe_canon(const Fe& x) {
  if (F == FIELD_SCALAR) {
    uint32_t r[9];
#pragma unroll
    for (int i = 0; i < OTTI_NW; ++i) r[i] = x.w[i];
    r[8] = 0;
    return scalar_canon9(r);
  }
  return base_canon8(x);
}

// ---------------------------------------------------------------------------
// multiply, add, subtract
// ---------------------------------------------------------------------------

// a * b mod m, canonical, for any a, b in [0, 2^256).
template <int F>
OTTI_FN Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t p[2 * OTTI_NW];
  mul_words<OTTI_NW, OTTI_NW>(a.w, b.w, p);  // p < 2^512
  if (F == FIELD_SCALAR) {
    const uint32_t* c = FC[FIELD_SCALAR].tail;
    // p = p0 + 2^252 p1, p1 < 2^260;  q = c * p1 < 2^385
    uint32_t p1[9], q[13];
    shr252<9, 16>(p, p1);
    mul_words<4, 9>(c, p1, q);
    // q = q0 + 2^252 q1, q1 < 2^133;  s = c * q1 < 2^258
    uint32_t q1[5], s[9];
    shr252<5, 13>(q, q1);
    mul_words<4, 5>(c, q1, s);
    // p == p0 - q0 + s (mod l); r = p0 + s + l - q0 lies in (0, 2^259)
    // because q0 < 2^252 < l.
    uint32_t r[9];
#pragma unroll
    for (int i = 0; i < OTTI_NW; ++i) r[i] = p[i];
    r[7] &= 0x0FFFFFFFu;
    r[8] = 0;
    add_words<9, 9>(r, s);
    add_words<9, OTTI_NW>(r, FC[FIELD_SCALAR].mod);
    q[7] &= 0x0FFFFFFFu;
    sub_words<9, OTTI_NW>(r, q);
    return scalar_canon9(r);
  }
  // BASE: p = lo + 2^256 hi == lo + 38 hi, a 9-word value with top word
  // t <= 38; fold t the same way; a carry out of that (value wrapped past
  // 2^256, so what is left is < 38 * 39) is worth another 38.
  const uint32_t k = FC[FIELD_BASE].fold;
  Fe x;
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) {
    acc += (uint64_t)k * p[OTTI_NW + i] + p[i];
    x.w[i] = (uint32_t)acc;
    acc >>= 32;
  }
  uint32_t t = k * (uint32_t)acc;
  const uint32_t wrapped = add_words<OTTI_NW, 1>(x.w, &t);
  x.w[0] += k * wrapped;
  return base_canon8(x);
}

// Canonical a + b for canonical a, b (the sum is below 2m < 2^256).
template <int F>
OTTI_FN Fe fe_add(const Fe& a, const Fe& b) {
  Fe x = a;
  add_words<OTTI_NW, OTTI_NW>(x.w, b.w);
  cond_sub<F>(x);
  return x;
}

// Canonical a - b for canonical a, b (a + m - b lies in (0, 2m)).
template <int F>
OTTI_FN Fe fe_sub(const Fe& a, const Fe& b) {
  Fe x = a;
  add_words<OTTI_NW, OTTI_NW>(x.w, FC[F].mod);
  sub_words<OTTI_NW, OTTI_NW>(x.w, b.w);
  cond_sub<F>(x);
  return x;
}

// ---------------------------------------------------------------------------
// 22 x 12-bit limbs <-> 8 x 32-bit words
// ---------------------------------------------------------------------------

// Semi-form limbs (see the contract at the top) -> words of the same value.
// Pairs of limbs make 24-bit chunks, an exact signed carry runs over the 11
// chunks, and four chunks (96 bits) make three words.
OTTI_FN Fe fe_pack(const int32_t* x) {
  int32_t c[OTTI_NL / 2];
#pragma unroll
  for (int j = 0; j < OTTI_NL / 2; ++j) c[j] = x[2 * j] + x[2 * j + 1] * 4096;
  int32_t cr = 0;
#pragma unroll
  for (int j = 0; j < OTTI_NL / 2 - 1; ++j) {
    const int32_t v = c[j] + cr;
    c[j] = v & 0xFFFFFF;
    cr = v >> 24;  // arithmetic shift: floor division for negatives
  }
  c[OTTI_NL / 2 - 1] += cr;  // in [0, 2^16) for a value in [0, 2^256)
  uint32_t u[12];
#pragma unroll
  for (int j = 0; j < OTTI_NL / 2; ++j) u[j] = (uint32_t)c[j];
  u[11] = 0;
  Fe r;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const uint32_t* q = u + 4 * g;
    r.w[3 * g] = q[0] | (q[1] << 24);
    r.w[3 * g + 1] = (q[1] >> 8) | (q[2] << 16);
    if (g < 2) r.w[3 * g + 2] = (q[2] >> 16) | (q[3] << 8);
  }
  return r;
}

// Canonical words -> 22 limbs in [0, 2^12).
OTTI_FN void fe_unpack(const Fe& a, int32_t* x) {
#pragma unroll
  for (int i = 0; i < OTTI_NL; ++i) {
    const int bit = 12 * i, j = bit >> 5, off = bit & 31;
    uint32_t v = a.w[j] >> off;
    if (off > 20 && j + 1 < OTTI_NW) v |= a.w[j + 1] << (32 - off);
    x[i] = (int32_t)(v & OTTI_LM);
  }
}

#ifdef __CUDACC__
// A row of 22 limbs in shared or global memory (8-byte aligned: rows are
// 88 B apart) <-> words, with 8-byte accesses.
__device__ __forceinline__ Fe fe_load_row(const int32_t* row) {
  int32_t x[OTTI_NL];
  const int2* p = reinterpret_cast<const int2*>(row);
#pragma unroll
  for (int i = 0; i < OTTI_NL / 2; ++i) {
    const int2 v = p[i];
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
  return fe_pack(x);
}

__device__ __forceinline__ void fe_store_row(int32_t* row, const Fe& z) {
  int32_t x[OTTI_NL];
  fe_unpack(z, x);
  int2* p = reinterpret_cast<int2*>(row);
#pragma unroll
  for (int i = 0; i < OTTI_NL / 2; ++i) p[i] = make_int2(x[2 * i], x[2 * i + 1]);
}
#endif
