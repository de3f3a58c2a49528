// The device arithmetic of field.cuh, ristretto.cuh, keccak.cuh, strobe.cuh
// and zk_round.cuh compiled for the host, so that a CPU test can hold the very
// code the kernels run against Python integers, the JAX package and the host
// library:
//   g++ -O2 -std=c++17 -shared -fPIC -o libotti_field_host.so host_check.cpp
// No kernel is built from this file.
#include "field.cuh"
#include "ristretto.cuh"
#include "keccak.cuh"
#include "strobe.cuh"
#include "zk_round.cuh"

extern "C" void otti_host_set_consts(const int32_t* consts) {
  set_field_consts(consts);
}

// out[i] = a[i] * b[i] mod m over [n, 22] limb rows, canonical.
extern "C" void otti_host_mul(const int32_t* a, const int32_t* b, int32_t* out,
                              long long n, int field) {
  for (long long i = 0; i < n; ++i) {
    const Fe x = fe_pack(a + i * OTTI_NL), y = fe_pack(b + i * OTTI_NL);
    const Fe z = field == FIELD_SCALAR ? fe_mul<FIELD_SCALAR>(x, y)
                                       : fe_mul<FIELD_BASE>(x, y);
    fe_unpack(z, out + i * OTTI_NL);
  }
}

// op 0: canon(a); 1: canon(a) + canon(b); 2: canon(a) - canon(b).
extern "C" void otti_host_addsub(const int32_t* a, const int32_t* b, int32_t* out,
                                 long long n, int field, int op) {
  for (long long i = 0; i < n; ++i) {
    Fe z;
    if (field == FIELD_SCALAR) {
      const Fe x = fe_canon<FIELD_SCALAR>(fe_pack(a + i * OTTI_NL));
      const Fe y = fe_canon<FIELD_SCALAR>(fe_pack(b + i * OTTI_NL));
      z = op == 0 ? x : op == 1 ? fe_add<FIELD_SCALAR>(x, y) : fe_sub<FIELD_SCALAR>(x, y);
    } else {
      const Fe x = fe_canon<FIELD_BASE>(fe_pack(a + i * OTTI_NL));
      const Fe y = fe_canon<FIELD_BASE>(fe_pack(b + i * OTTI_NL));
      z = op == 0 ? x : op == 1 ? fe_add<FIELD_BASE>(x, y) : fe_sub<FIELD_BASE>(x, y);
    }
    fe_unpack(z, out + i * OTTI_NL);
  }
}

// consts: FieldConsts[2] then RistrettoConsts, as otti_ristretto_init takes them.
extern "C" void otti_host_set_ristretto_consts(const int32_t* consts) {
  set_field_consts(consts);
  set_ristretto_consts(reinterpret_cast<const uint32_t*>(consts) + sizeof(FieldConsts) * 2 / 4);
}

// out[32 i ..] = the ristretto encoding of point i of [n, 22] limb rows x, y, z, t.
extern "C" void otti_host_ristretto_encode(const int32_t* x, const int32_t* y, const int32_t* z,
                                           const int32_t* t, uint8_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    const long long o = i * OTTI_NL;
    ristretto_encode_fe(fe_pack(x + o), fe_pack(y + o), fe_pack(z + o), fe_pack(t + o),
                        out + 32 * i);
  }
}

// Loose BASE arithmetic on 8-word values (no packing): op 0: a * b, op 1:
// a^2, each in [0, 2^256) and not canonical.
extern "C" void otti_host_loose(const uint32_t* a, const uint32_t* b, uint32_t* out,
                                long long n, int op) {
  for (long long i = 0; i < n; ++i) {
    Fe x, y;
    memcpy(x.w, a + OTTI_NW * i, sizeof(x.w));
    memcpy(y.w, b + OTTI_NW * i, sizeof(y.w));
    const Fe z = op == 0 ? fe_mul_loose(x, y) : fe_sq_loose(x);
    memcpy(out + OTTI_NW * i, z.w, sizeof(z.w));
  }
}

// Keccak-f[1600] of n 200-byte states in place, STROBE's pad first when
// pos >= 0 (as otti_keccak_pad_f1600 takes them): keccak.cuh's rounds on the
// host's warp model.
extern "C" void otti_host_keccak_pad_f1600(uint8_t* states, long long n, int pos,
                                           int pos_begin) {
  const KeccakWarp w;
  for (long long i = 0; i < n; ++i) {
    uint64_t lanes[KECCAK_LANES];
    memcpy(lanes, states + 200 * i, sizeof(lanes));
    KeccakLanes a;
    for (int l = 0; l < 32; ++l) a.l[l] = lanes[w.t[l]] ^ strobe_pad_lane(w.t[l], pos, pos_begin);
    a = keccak_rounds(w, a);
    memcpy(states + 200 * i, a.l, sizeof(lanes));
  }
}

// The tables compiled into keccak.cuh: 24 round constants, the rho+pi
// sources and rotations.
extern "C" void otti_host_keccak_tables(uint64_t* rc, int32_t* pi_src, int32_t* pi_rot) {
  memcpy(rc, KECCAK_RC, sizeof(KECCAK_RC));
  memcpy(pi_src, KECCAK_PI_SRC, sizeof(KECCAK_PI_SRC));
  memcpy(pi_rot, KECCAK_PI_ROT, sizeof(KECCAK_PI_ROT));
}

// A sumcheck round's transcript step as kernel 5's fused entry runs it
// (strobe.cuh's merlin_round): state (200 bytes, in place) at offsets[0..2]
// = pos, pos_begin, cur_flags (updated) absorbs the values (32 bytes each)
// under the labels of prog and squeezes 64 bytes into out64.
extern "C" void otti_host_merlin_round(uint8_t* state, int32_t* offsets, const uint8_t* prog,
                                       const uint8_t* values32, uint8_t* out64) {
  uint64_t lanes[KECCAK_LANES];  // the state 8-byte aligned, as in shared memory
  memcpy(lanes, state, sizeof(lanes));
  const StrobeWarp w;
  Strobe s = {reinterpret_cast<uint8_t*>(lanes), offsets[0], offsets[1], offsets[2]};
  merlin_round(w, s, prog, values32, out64);
  memcpy(state, lanes, sizeof(lanes));
  offsets[0] = s.pos;
  offsets[1] = s.pos_begin;
  offsets[2] = s.cur_flags;
}

// limbs[22 i ..] = the 64 little-endian bytes b[64 i ..] mod l, canonical.
extern "C" void otti_host_scalar_from_le64(const uint8_t* b, int32_t* limbs, long long n) {
  for (long long i = 0; i < n; ++i) fe_unpack(scalar_from_le64(b + 64 * i), limbs + OTTI_NL * i);
}

// consts: FieldConsts[2], RistrettoConsts, then ZkConsts, as
// otti_zk_round_init takes them.
extern "C" void otti_host_set_zk_round_consts(const int32_t* consts) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(consts);
  set_field_consts(consts);
  set_ristretto_consts(words + sizeof(FieldConsts) * 2 / 4);
  set_zk_consts(words + (sizeof(FieldConsts) * 2 + sizeof(RistrettoConsts)) / 4);
}

// One zero-knowledge round of one instance as a block of kernel K6 runs it
// (zk_round.cuh): in = the rows of evs, e, be, b_poly, b_next, d, r_delta,
// r_beta; state (200 bytes, in place) at the STROBE offsets offsets[0..2];
// prog the labels (zk_round_kernel.round_program).  Returns 1 for a degree
// other than 2 or 3.
extern "C" int otti_host_zk_round(const int32_t* const* in, const int32_t* vinv,
                                  const int32_t* table, const uint8_t* prog, uint8_t* state,
                                  const int32_t* offsets, int32_t* e_next, int32_t* r,
                                  uint8_t* encs, int32_t* z, int32_t* zdb, int degree) {
  const ZrIo io = {in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], vinv, table, prog,
                   state, offsets[0], offsets[1], offsets[2], e_next, r, z, zdb, encs};
  ZrShared sh;
  if (degree == 2)
    zk_round<2>(ZrBlock(), sh, io);
  else if (degree == 3)
    zk_round<3>(ZrBlock(), sh, io);
  else
    return 1;
  return 0;
}
