// ristretto255 encoding of one extended Edwards point (RFC 9496 4.3.2) on
// the word arithmetic of field.cuh, BASE field.  Every value is a canonical
// Fe; fe_mul returns canonical products, fe_add / fe_sub take and return
// canonical values, so the sign tests read bit 0 of word 0 directly.
//
// Like field.cuh this is plain C++ and compiles for the host as well
// (csrc/host_check.cpp), where a CPU test holds it against the JAX
// package's encode and the host library.
#pragma once

#include "field.cuh"

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

OTTI_FN Fe fe_sq(const Fe& a) { return fe_mul<FIELD_BASE>(a, a); }

// a^(2^k) by k squarings.
OTTI_FN Fe fe_sq_n(Fe a, int k) {
  for (int i = 0; i < k; ++i) a = fe_sq(a);
  return a;
}

// z^((p - 5) / 8) = z^(2^252 - 3): the fixed addition chain of ref10's
// pow22523, 251 squarings and 11 multiplies.
OTTI_FN Fe fe_pow22523(const Fe& z) {
  Fe t0 = fe_sq(z);                                 // z^2
  Fe t1 = fe_mul<FIELD_BASE>(z, fe_sq_n(t0, 2));    // z^9
  t0 = fe_mul<FIELD_BASE>(t0, t1);                  // z^11
  t0 = fe_mul<FIELD_BASE>(t1, fe_sq(t0));           // z^(2^5 - 1)
  t0 = fe_mul<FIELD_BASE>(fe_sq_n(t0, 5), t0);      // z^(2^10 - 1)
  t1 = fe_mul<FIELD_BASE>(fe_sq_n(t0, 10), t0);     // z^(2^20 - 1)
  t1 = fe_mul<FIELD_BASE>(fe_sq_n(t1, 20), t1);     // z^(2^40 - 1)
  t0 = fe_mul<FIELD_BASE>(fe_sq_n(t1, 10), t0);     // z^(2^50 - 1)
  t1 = fe_mul<FIELD_BASE>(fe_sq_n(t0, 50), t0);     // z^(2^100 - 1)
  t1 = fe_mul<FIELD_BASE>(fe_sq_n(t1, 100), t1);    // z^(2^200 - 1)
  t0 = fe_mul<FIELD_BASE>(fe_sq_n(t1, 50), t0);     // z^(2^250 - 1)
  return fe_mul<FIELD_BASE>(fe_sq_n(t0, 2), z);     // z^(2^252 - 3)
}

OTTI_FN bool fe_is_neg(const Fe& a) { return (a.w[0] & 1u) != 0; }

OTTI_FN bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) d |= a.w[i] ^ b.w[i];
  return d == 0;
}

OTTI_FN Fe fe_neg(const Fe& a) {
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

// SQRT_RATIO_M1(1, v): the nonnegative root of 1/v (or of i/v).
OTTI_FN Fe invsqrt_ratio(const Fe& v) {
  const Fe i = fe_const(RC25519.sqrt_m1);
  const Fe v3 = fe_mul<FIELD_BASE>(fe_sq(v), v);
  const Fe v7 = fe_mul<FIELD_BASE>(fe_sq(v3), v);
  Fe r = fe_mul<FIELD_BASE>(v3, fe_pow22523(v7));  // u = 1
  const Fe check = fe_mul<FIELD_BASE>(v, fe_sq(r));
  Fe one;
#pragma unroll
  for (int k = 0; k < OTTI_NW; ++k) one.w[k] = 0;
  one.w[0] = 1;
  const Fe neg_u = fe_neg(one);
  const bool flipped = fe_eq(check, neg_u);
  const bool flipped_i = fe_eq(check, fe_mul<FIELD_BASE>(neg_u, i));
  r = fe_sel(flipped || flipped_i, fe_mul<FIELD_BASE>(r, i), r);
  return fe_sel(fe_is_neg(r), fe_neg(r), r);
}

// The 32-byte encoding of (X : Y : Z : T), any representatives in [0, 2^256).
OTTI_FN void ristretto_encode_fe(Fe X, Fe Y, Fe Z, Fe T, uint8_t* out) {
  X = fe_canon<FIELD_BASE>(X);
  Y = fe_canon<FIELD_BASE>(Y);
  Z = fe_canon<FIELD_BASE>(Z);
  T = fe_canon<FIELD_BASE>(T);
  const Fe i = fe_const(RC25519.sqrt_m1);
  const Fe u1 = fe_mul<FIELD_BASE>(fe_add<FIELD_BASE>(Z, Y), fe_sub<FIELD_BASE>(Z, Y));
  const Fe u2 = fe_mul<FIELD_BASE>(X, Y);
  const Fe invsqrt = invsqrt_ratio(fe_mul<FIELD_BASE>(u1, fe_sq(u2)));
  const Fe den1 = fe_mul<FIELD_BASE>(invsqrt, u1);
  const Fe den2 = fe_mul<FIELD_BASE>(invsqrt, u2);
  const Fe z_inv = fe_mul<FIELD_BASE>(fe_mul<FIELD_BASE>(den1, den2), T);
  const Fe ix = fe_mul<FIELD_BASE>(X, i);
  const Fe iy = fe_mul<FIELD_BASE>(Y, i);
  const Fe enchanted = fe_mul<FIELD_BASE>(den1, fe_const(RC25519.invsqrt_a_minus_d));
  const bool rotate = fe_is_neg(fe_mul<FIELD_BASE>(T, z_inv));
  const Fe xr = fe_sel(rotate, iy, X);
  const Fe yr = fe_sel(rotate, ix, Y);
  const Fe den_inv = fe_sel(rotate, enchanted, den2);
  const bool y_neg = fe_is_neg(fe_mul<FIELD_BASE>(xr, z_inv));
  const Fe yf = fe_sel(y_neg, fe_neg(yr), yr);
  Fe s = fe_mul<FIELD_BASE>(den_inv, fe_sub<FIELD_BASE>(Z, yf));
  s = fe_sel(fe_is_neg(s), fe_neg(s), s);
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * w + k] = (uint8_t)(s.w[w] >> (8 * k));
}
