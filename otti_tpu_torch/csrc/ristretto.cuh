// ristretto255 encoding of one extended Edwards point (RFC 9496 4.3.2) on
// the word arithmetic of field.cuh, BASE field (p = 2^255 - 19).
//
// The chain of an encoding is about 285 dependent multiplies, 251 of them
// the squarings of the inverse square root, so it runs on its own "loose"
// multiply and square (below): they fold 2^256 = 38 and return any value in
// [0, 2^256), without field.cuh's final canonicalisation.  Every input in
// [0, 2^256) is accepted, so loose values feed each other directly.  A value
// is canonicalised only where the code reads its bits as a field element: a
// comparison, a sign test (bit 0), an input of fe_add / fe_sub (which take
// canonical values), and the bytes written out.  Each such point says why.
// field.cuh's fe_mul / fe_add / fe_sub / fe_canon are not changed, so the
// multiply and sumcheck kernels compile as before.
//
// Like field.cuh this compiles for the host as well (csrc/host_check.cpp),
// where a CPU test holds it against Python integers, the JAX package's
// encode and the host library.  On the device the products and the fold are
// written with PTX carry instructions; on the host (or with OTTI_NO_PTX) the
// same arithmetic is plain C++ on 64-bit integers.
#pragma once

#include "field.cuh"

#if defined(__CUDA_ARCH__) && !defined(OTTI_NO_PTX)
#define OTTI_PTX 1
#endif

struct RistrettoConsts {
  uint32_t sqrt_m1[OTTI_NW];            // sqrt(-1) mod p
  uint32_t invsqrt_a_minus_d[OTTI_NW];  // 1 / sqrt(a - d), a = -1
};

OTTI_CONST RistrettoConsts RC25519;

static int set_ristretto_consts(const uint32_t* host) {
#ifdef __CUDACC__
  return (int)cudaMemcpyToSymbol(RC25519, host, sizeof(RistrettoConsts));
#else
  memcpy(&RC25519, host, sizeof(RistrettoConsts));
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// loose BASE multiply and square: [0, 2^256) x [0, 2^256) -> [0, 2^256)
// ---------------------------------------------------------------------------

#ifdef OTTI_PTX
// (c0, c1, c2) += a * b: one product into a three-word column accumulator.
// The carry flag lives only inside this statement.
__device__ __forceinline__ void mac3(uint32_t& c0, uint32_t& c1, uint32_t& c2, uint32_t a,
                                     uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(a), "r"(b));
}
#endif

// r[0..16) = a * b (512 bits).  Device: product scanning, column k the sum
// of a[i] b[k - i] in a three-word accumulator, so that each product costs
// three dependent carry instructions and the column's carries move on with
// the accumulator instead of through a row of partial words.
OTTI_FN void mul8_wide(const uint32_t* a, const uint32_t* b, uint32_t* r) {
#ifdef OTTI_PTX
  uint32_t c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < 2 * OTTI_NW - 1; ++k) {
#pragma unroll
    for (int i = 0; i < OTTI_NW; ++i)  // a fixed trip count: unrolled, r stays in registers
      if (i <= k && k - i < OTTI_NW) mac3(c0, c1, c2, a[i], b[k - i]);
    r[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  r[2 * OTTI_NW - 1] = c0;
#else
  mul_words<OTTI_NW, OTTI_NW>(a, b, r);
#endif
}

// r[0..16) = a^2 with 36 word products: the 28 cross products a[i] a[j],
// i < j, summed once, the sum doubled by a one-bit shift (it is below 2^511),
// then the 8 squares a[i]^2 added at words 2i, 2i + 1.
OTTI_FN void sq8_wide(const uint32_t* a, uint32_t* r) {
#ifdef OTTI_PTX
  uint32_t c0 = 0, c1 = 0, c2 = 0;
  r[0] = 0;
#pragma unroll
  for (int k = 1; k < 2 * OTTI_NW - 2; ++k) {
#pragma unroll
    for (int i = 0; i < OTTI_NW; ++i)
      if (2 * i < k && k - i < OTTI_NW) mac3(c0, c1, c2, a[i], a[k - i]);
    r[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  r[2 * OTTI_NW - 2] = c0;
  r[2 * OTTI_NW - 1] = c1;
#pragma unroll
  for (int k = 2 * OTTI_NW - 1; k > 0; --k) r[k] = __funnelshift_l(r[k - 1], r[k], 1);
  r[0] = 0;  // the cross products start at word 1
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]), "+r"(r[11]), "+r"(r[12]),
        "+r"(r[13]), "+r"(r[14]), "+r"(r[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]));
#else
#pragma unroll
  for (int k = 0; k < 2 * OTTI_NW; ++k) r[k] = 0;
#pragma unroll
  for (int i = 0; i < OTTI_NW - 1; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = i + 1; j < OTTI_NW; ++j) {
      const uint64_t t = (uint64_t)a[i] * a[j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    r[i + OTTI_NW] = (uint32_t)carry;
  }
#pragma unroll
  for (int k = 2 * OTTI_NW - 1; k > 0; --k) r[k] = (r[k] << 1) | (r[k - 1] >> 31);
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) {
    const uint64_t t = (uint64_t)a[i] * a[i] + r[2 * i] + carry;
    r[2 * i] = (uint32_t)t;
    const uint64_t u = (t >> 32) + r[2 * i + 1];
    r[2 * i + 1] = (uint32_t)u;
    carry = u >> 32;
  }
#endif
}

// lo + 2^256 hi == lo + 38 hi (mod p) for the 512-bit r, into [0, 2^256):
// the sum is a 9-word value with top word t <= 38; 38 t is added at word 0,
// and a carry out of word 7 (the value wrapped past 2^256, so what is left
// is below 38 * 39) is worth another 38.  fe_mul's BASE fold, without its
// canonicalisation.
OTTI_FN Fe fold38(const uint32_t* r) {
  Fe x;
#ifdef OTTI_PTX
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) x.w[i] = r[i];
  uint32_t top = 0;
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(x.w[0]), "+r"(x.w[1]), "+r"(x.w[2]), "+r"(x.w[3]), "+r"(x.w[4]), "+r"(x.w[5]),
        "+r"(x.w[6]), "+r"(x.w[7]), "+r"(top)
      : "r"(r[8]), "r"(r[9]), "r"(r[10]), "r"(r[11]), "r"(r[12]), "r"(r[13]), "r"(r[14]),
        "r"(r[15]), "r"(38u));
  uint32_t wrapped = 0;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(x.w[0]), "+r"(x.w[1]), "+r"(x.w[2]), "+r"(x.w[3]), "+r"(x.w[4]), "+r"(x.w[5]),
        "+r"(x.w[6]), "+r"(x.w[7]), "+r"(wrapped)
      : "r"(38u * top));
  x.w[0] += 38u * wrapped;
#else
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) {
    acc += 38ull * r[OTTI_NW + i] + r[i];
    x.w[i] = (uint32_t)acc;
    acc >>= 32;
  }
  uint32_t t = 38u * (uint32_t)acc;
  const uint32_t wrapped = add_words<OTTI_NW, 1>(x.w, &t);
  x.w[0] += 38u * wrapped;
#endif
  return x;
}

// a * b and a^2 mod p, each in [0, 2^256) but not canonical.
OTTI_FN Fe fe_mul_loose(const Fe& a, const Fe& b) {
  uint32_t r[2 * OTTI_NW];
  mul8_wide(a.w, b.w, r);
  return fold38(r);
}

OTTI_FN Fe fe_sq_loose(const Fe& a) {
  uint32_t r[2 * OTTI_NW];
  sq8_wide(a.w, r);
  return fold38(r);
}

// a^(2^k) by k squarings.
OTTI_FN Fe fe_sq_n(Fe a, int k) {
  for (int i = 0; i < k; ++i) a = fe_sq_loose(a);
  return a;
}

// z^((p - 5) / 8) = z^(2^252 - 3): the fixed addition chain of ref10's
// pow22523, 251 squarings and 11 multiplies, all loose.
OTTI_FN Fe fe_pow22523(const Fe& z) {
  Fe t0 = fe_sq_loose(z);                          // z^2
  Fe t1 = fe_mul_loose(z, fe_sq_n(t0, 2));         // z^9
  t0 = fe_mul_loose(t0, t1);                       // z^11
  t0 = fe_mul_loose(t1, fe_sq_loose(t0));          // z^(2^5 - 1)
  t0 = fe_mul_loose(fe_sq_n(t0, 5), t0);           // z^(2^10 - 1)
  t1 = fe_mul_loose(fe_sq_n(t0, 10), t0);          // z^(2^20 - 1)
  t1 = fe_mul_loose(fe_sq_n(t1, 20), t1);          // z^(2^40 - 1)
  t0 = fe_mul_loose(fe_sq_n(t1, 10), t0);          // z^(2^50 - 1)
  t1 = fe_mul_loose(fe_sq_n(t0, 50), t0);          // z^(2^100 - 1)
  t1 = fe_mul_loose(fe_sq_n(t1, 100), t1);         // z^(2^200 - 1)
  t0 = fe_mul_loose(fe_sq_n(t1, 50), t0);          // z^(2^250 - 1)
  return fe_mul_loose(fe_sq_n(t0, 2), z);          // z^(2^252 - 3)
}

// ---------------------------------------------------------------------------
// the encoding
// ---------------------------------------------------------------------------

OTTI_FN Fe base_canon(const Fe& a) { return fe_canon<FIELD_BASE>(a); }

OTTI_FN bool fe_is_neg(const Fe& a) { return (a.w[0] & 1u) != 0; }  // a canonical

OTTI_FN bool fe_eq(const Fe& a, const Fe& b) {  // a, b canonical
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) d |= a.w[i] ^ b.w[i];
  return d == 0;
}

OTTI_FN Fe fe_neg(const Fe& a) {  // a canonical
  Fe zero;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) zero.w[i] = 0;
  return fe_sub<FIELD_BASE>(zero, a);
}

OTTI_FN Fe fe_sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

OTTI_FN Fe fe_const(const uint32_t* w) {
  Fe r;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) r.w[i] = w[i];
  return r;
}

// SQRT_RATIO_M1(1, v) for a loose v: the canonical nonnegative root of 1/v
// (or of i/v).
OTTI_FN Fe invsqrt_ratio(const Fe& v) {
  const Fe i = fe_const(RC25519.sqrt_m1);  // canonical
  const Fe v3 = fe_mul_loose(fe_sq_loose(v), v);
  const Fe v7 = fe_mul_loose(fe_sq_loose(v3), v);
  Fe r = fe_mul_loose(v3, fe_pow22523(v7));  // u = 1
  // canonical: compared with -1 and -i
  const Fe check = base_canon(fe_mul_loose(v, fe_sq_loose(r)));
  Fe one;
#pragma unroll
  for (int k = 0; k < OTTI_NW; ++k) one.w[k] = 0;
  one.w[0] = 1;
  const bool flipped = fe_eq(check, fe_neg(one));
  const bool flipped_i = fe_eq(check, fe_neg(i));  // -u i with u = 1
  // canonical: its sign is read, and fe_neg takes canonical values
  r = base_canon(fe_sel(flipped || flipped_i, fe_mul_loose(r, i), r));
  return fe_sel(fe_is_neg(r), fe_neg(r), r);
}

// The 32-byte encoding of (X : Y : Z : T), any representatives in [0, 2^256).
OTTI_FN void ristretto_encode_fe(const Fe& X, Fe Y, Fe Z, const Fe& T, uint8_t* out) {
  Y = base_canon(Y);  // canonical: Y and Z enter fe_add / fe_sub
  Z = base_canon(Z);
  const Fe i = fe_const(RC25519.sqrt_m1);
  const Fe u1 = fe_mul_loose(fe_add<FIELD_BASE>(Z, Y), fe_sub<FIELD_BASE>(Z, Y));
  const Fe u2 = fe_mul_loose(X, Y);
  const Fe invsqrt = invsqrt_ratio(fe_mul_loose(u1, fe_sq_loose(u2)));
  const Fe den1 = fe_mul_loose(invsqrt, u1);
  const Fe den2 = fe_mul_loose(invsqrt, u2);
  const Fe z_inv = fe_mul_loose(fe_mul_loose(den1, den2), T);
  const Fe ix = fe_mul_loose(X, i);
  const Fe iy = fe_mul_loose(Y, i);
  const Fe enchanted = fe_mul_loose(den1, fe_const(RC25519.invsqrt_a_minus_d));
  const bool rotate = fe_is_neg(fe_mul<FIELD_BASE>(T, z_inv));  // canonical: sign read
  const Fe xr = fe_sel(rotate, iy, X);
  const Fe yr = base_canon(fe_sel(rotate, ix, Y));  // canonical: negated and subtracted
  const Fe den_inv = fe_sel(rotate, enchanted, den2);
  const bool y_neg = fe_is_neg(fe_mul<FIELD_BASE>(xr, z_inv));  // canonical: sign read
  const Fe yf = fe_sel(y_neg, fe_neg(yr), yr);
  // canonical: its sign is read and it is written out
  Fe s = fe_mul<FIELD_BASE>(den_inv, fe_sub<FIELD_BASE>(Z, yf));
  s = fe_sel(fe_is_neg(s), fe_neg(s), s);
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * w + k] = (uint8_t)(s.w[w] >> (8 * k));
}
