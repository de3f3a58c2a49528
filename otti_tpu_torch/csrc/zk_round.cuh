// One zero-knowledge sumcheck round after its evaluations, as one block of
// kernel K6 runs it (csrc/zk_round.cu): spartan/zkfused.py
// _zk_round_from_evals step for step.
//
// Given the round's evaluations p(0), p(2)(, p(3)), the running claim e and
// its blind, the round's blinds (b_poly, b_next, d, r_delta, r_beta), the
// comb table of G_0..G_degree and H and the transcript's sponge state, it
//   1. inserts p(1) = e - p(0) and takes the coefficients by the inverse
//      Vandermonde matrix;
//   2. commits C_poly and delta (group 1) and encodes both;
//   3. absorbs comm_poly and squeezes r;
//   4. evaluates e_next by Horner, commits and encodes comm_eval, squeezes
//      w0 and w1;
//   5. builds the weights a = w0 (2, 1, .., 1) + w1 (1, r, r^2, ..), y,
//      ry_b and dy;
//   6. commits and encodes C_y and beta (group 3);
//   7. absorbs the dot-product proof's messages and squeezes c;
//   8. computes z and zdb,
// and writes e_next, r, the four encodings, z, zdb and the sponge state.
// Every value is the torch round's, mod l; the outputs are canonical (the
// torch round leaves e_next in a semi form of the same value).
//
// A commitment is a comb sum over the table (msm/pippenger.py's layout:
// entry (gen * 32 + window) * 256 + digit, packed affine x | y): each of
// ZR_SLOTS threads adds the entries of every ZR_SLOTS-th (scalar, window)
// digit, then a tree in shared memory sums the slots (log2 ZR_SLOTS levels);
// the points stay in shared memory, which holds the operands of each
// addition's products.  Two commitments of a group run side by side on the
// block's two halves and their two encodings on two lanes.  A point sum's projective
// representative differs from the torch tree's, its encoding does not
// (ristretto255 encodes the group element).  The transcript is
// csrc/strobe.cuh's Merlin on one warp, the state in shared memory, under
// the labels of a byte program (spartan/zk_round_kernel.py round_program):
// its count, the lengths, then the labels of enum ZrLabel in order.
//
// Written once over a "block model" ZrBlock, as strobe.cuh is over its
// warp model:
//   blk.pfor(n, f)    f(i) for i < n spread over the block's threads, then
//                     a barrier;
//   blk.warp0(f)      f(w) on the one warp that runs the transcript (w a
//                     StrobeWarp), then a barrier.
// Compiled by nvcc, a block of ZR_THREADS threads; compiled for the host
// (csrc/host_check.cpp), one thread that runs every i in turn, so a CPU
// test holds this very round against the torch round.
#pragma once

#include "ristretto.cuh"
#include "strobe.cuh"

#define ZR_THREADS 128
#define ZR_SLOTS 64                  // tree leaves a commitment: two fill the block
#define ZR_MAX_DEG 3
#define ZR_MAX_SC (ZR_MAX_DEG + 2)  // scalars of a commitment: G_0..G_degree, then H
#define ZR_NWIN 32                   // comb windows of 8 bits
#define ZR_NDIG 256
#define ZR_ENTRY_WORDS 16            // packed affine x | y

// The labels of the byte program, in order (ZR_M_DOT is a message).
enum ZrLabel {
  ZR_L_POLY,   // label/comm_poly
  ZR_L_R,      // label/r
  ZR_L_EVAL,   // label/comm_eval
  ZR_L_W0,     // label/w0
  ZR_L_W1,     // label/w1
  ZR_L_PROTO,  // protocol-name
  ZR_M_DOT,    // "dot product proof"
  ZR_L_CX,
  ZR_L_CY,
  ZR_L_A,
  ZR_L_DELTA,
  ZR_L_BETA,
  ZR_L_C,
  ZR_LABELS
};

// Encodings in shared memory; the first four are the output's, in its order.
enum { ZR_E_POLY, ZR_E_EVAL, ZR_E_DELTA, ZR_E_BETA, ZR_E_CY, ZR_ENCS };

struct ZkConsts {
  uint32_t d2[OTTI_NW];  // 2 d mod p, the curve constant of the addition
};

OTTI_CONST ZkConsts ZKC;

static int set_zk_consts(const uint32_t* host) {
#ifdef __CUDACC__
  return (int)cudaMemcpyToSymbol(ZKC, host, sizeof(ZkConsts));
#else
  memcpy(&ZKC, host, sizeof(ZkConsts));
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// points: extended coordinates over BASE, each coordinate canonical
// ---------------------------------------------------------------------------

struct Pt {
  Fe x, y, z, t;
};

OTTI_FN Fe fe_small(uint32_t v) {
  Fe r;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) r.w[i] = 0;
  r.w[0] = v;
  return r;
}

OTTI_FN Pt pt_identity() { return {fe_small(0), fe_small(1), fe_small(1), fe_small(0)}; }

// A canonical BASE product by ristretto.cuh's loose multiply (its PTX
// carry chains on the card), then one canonicalisation.
OTTI_FN Fe fe_mulc(const Fe& a, const Fe& b) { return base_canon(fe_mul_loose(a, b)); }

// Four products u[k] <- u[k] v[k], two at a time: the four side by side
// hold their wide temporaries at once, and the kernel took 150 registers
// with them; two at a time keep it within 128 (one at a time was no
// faster).
OTTI_FN void fe_mulc4(Fe* u, const Fe* v) {
#pragma unroll 2
  for (int k = 0; k < 4; ++k) u[k] = fe_mulc(u[k], v[k]);
}

// p <- p + q, add-2008-hwcd-3 (a = -1), curve/edwards.py's add: complete on
// the prime-order subgroup, canonical coordinates in and out.  p and q lie
// in shared memory and hold the operands of the products, so q is
// clobbered; a point's coordinates x, y, z, t are four Fe in that order.
OTTI_FN void pt_acc(Pt* p, Pt* q) {
  Fe* u = &p->x;
  Fe* v = &q->x;
  // a = (y1 - x1)(y2 - x2), b = (y1 + x1)(y2 + x2), d = 2 z1 z2, tt = t1 t2
  const Fe x1 = u[0], y1 = u[1], x2 = v[0], y2 = v[1];
  u[0] = fe_sub<FIELD_BASE>(y1, x1);
  u[1] = fe_add<FIELD_BASE>(y1, x1);
  u[2] = fe_add<FIELD_BASE>(u[2], u[2]);
  v[0] = fe_sub<FIELD_BASE>(y2, x2);
  v[1] = fe_add<FIELD_BASE>(y2, x2);
  fe_mulc4(u, v);  // a, b, d, tt
  const Fe a = u[0], b = u[1], d = u[2], c = fe_mulc(u[3], fe_const(ZKC.d2));
  const Fe e = fe_sub<FIELD_BASE>(b, a), f = fe_sub<FIELD_BASE>(d, c);
  const Fe g = fe_add<FIELD_BASE>(d, c), h = fe_add<FIELD_BASE>(b, a);
  // x3 = e f, y3 = g h, z3 = f g, t3 = e h
  u[0] = e;
  v[0] = f;
  u[1] = g;
  v[1] = h;
  u[2] = f;
  v[2] = g;
  u[3] = e;
  v[3] = h;
  fe_mulc4(u, v);
}

// A comb-table entry (64 bytes, 64-byte aligned) as a point: z = 1, t = x y.
OTTI_FN void pt_entry(Pt* dst, const int32_t* e) {
  uint32_t v[ZR_ENTRY_WORDS];
#ifdef __CUDA_ARCH__
  const int4* p = reinterpret_cast<const int4*>(e);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 q = __ldg(p + i);
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
#else
  memcpy(v, e, sizeof(v));
#endif
  Fe x, y;
#pragma unroll
  for (int i = 0; i < OTTI_NW; ++i) {
    x.w[i] = v[i];
    y.w[i] = v[OTTI_NW + i];
  }
  dst->x = x;
  dst->y = y;
  dst->z = fe_small(1);
  dst->t = fe_mulc(x, y);
}

// ---------------------------------------------------------------------------
// rows of 22 limbs, scalars and bytes
// ---------------------------------------------------------------------------

// A semi-form SCALAR row (8-byte aligned) -> its canonical value.
OTTI_FN Fe zr_scalar(const int32_t* row) {
#ifdef __CUDACC__
  return fe_canon<FIELD_SCALAR>(fe_load_row(row));
#else
  return fe_canon<FIELD_SCALAR>(fe_pack(row));
#endif
}

OTTI_FN void zr_store(int32_t* row, const Fe& a) {
#ifdef __CUDACC__
  fe_store_row(row, a);
#else
  fe_unpack(a, row);
#endif
}

// The 32 little-endian bytes of a canonical value (limbs_to_bytes32).
OTTI_FN void fe_to_bytes(const Fe& a, uint8_t* out) {
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * w + k] = (uint8_t)(a.w[w] >> (8 * k));
}

OTTI_FN Fe s_mul(const Fe& a, const Fe& b) { return fe_mul<FIELD_SCALAR>(a, b); }
OTTI_FN Fe s_add(const Fe& a, const Fe& b) { return fe_add<FIELD_SCALAR>(a, b); }

// ---------------------------------------------------------------------------
// one instance's round
// ---------------------------------------------------------------------------

// Where one instance's round reads and writes.  Rows are 22 int32 limbs,
// 8-byte aligned; the state is 200 bytes, 8-byte aligned.
struct ZrIo {
  const int32_t *evs, *e, *be, *b_poly, *b_next, *d, *r_delta, *r_beta;
  const int32_t* vinv;   // [(degree + 1)^2, 22]: coefficients = vinv @ (p(0), p(1), ..)
  const int32_t* table;  // [(degree + 2) * 32 * 256, 16]: G_0..G_degree, H
  const uint8_t* prog;   // the labels
  uint8_t* state;        // in and out
  int pos, pos_begin, cur_flags;
  int32_t *e_next, *r, *z, *zdb;  // [22], [22], [degree + 1, 22], [2, 22]
  uint8_t* encs;                  // [4, 32]
};

struct ZrShared {
  uint64_t st[KECCAK_LANES];  // the sponge state
  Pt pts[2 * ZR_SLOTS];       // the commitments' trees
  Pt tmp[2 * ZR_SLOTS];       // each leaf's next table entry
  Fe ev[ZR_MAX_DEG + 1], coef[ZR_MAX_DEG + 1], dv[ZR_MAX_DEG + 1], a[ZR_MAX_DEG + 1];
  Fe e, be, b_poly, b_next, r_delta, r_beta, r, w0, w1, c, e_next, y, ry_b;
  Fe sc[2][ZR_MAX_SC];  // the scalars of the commitments at hand
  int gen[2][ZR_MAX_SC];  // and their generators
  uint8_t enc[ZR_ENCS][32];
  uint8_t abytes[ZR_MAX_DEG + 1][32];
  uint8_t ch[64];  // a challenge's bytes
  Strobe strobe;   // the state's offsets between the transcript's sections
  int lab_off[ZR_LABELS], lab_len[ZR_LABELS];
};

#ifdef __CUDACC__
struct ZrBlock {
  int tid;
  template <class F>
  __device__ __forceinline__ void pfor(int n, F f) const {
    for (int i = tid; i < n; i += ZR_THREADS) f(i);
    __syncthreads();
  }
  template <class F>
  __device__ __forceinline__ void warp0(F f) const {
    if (tid < 32) f(StrobeWarp(tid));
    __syncthreads();
  }
};
#define ZR_CALLED __device__ __noinline__
#else
struct ZrBlock {
  template <class F>
  void pfor(int n, F f) const {
    for (int i = 0; i < n; ++i) f(i);
  }
  template <class F>
  void warp0(F f) const {
    f(StrobeWarp());
  }
};
#define ZR_CALLED static
#endif

template <class W>
OTTI_FN void zr_append(const W& w, Strobe& s, const ZrShared& sh, const uint8_t* prog, int label,
                       const uint8_t* msg, int mlen) {
  merlin_append(w, s, prog + sh.lab_off[label], sh.lab_len[label], msg, mlen);
}

template <class W>
OTTI_FN void zr_challenge(const W& w, Strobe& s, ZrShared& sh, const uint8_t* prog, int label,
                          Fe* out) {
  merlin_challenge(w, s, prog + sh.lab_off[label], sh.lab_len[label], sh.ch, 64);
  if (w.lane == 0) *out = scalar_from_le64(sh.ch);
  w.sync();  // sh.ch is read before the next squeeze writes it
}

// The encoding of a point in shared memory, called and not inlined: its
// chain (K4's, about 120 registers) is allocated on its own, and its callers
// hold next to nothing across the call, so the kernel stays within 128
// registers without spills.
ZR_CALLED void zr_encode(const Pt* p, uint8_t* out) {
  ristretto_encode_fe(p->x, p->y, p->z, p->t, out);
}

// The strobe's offsets, the same in every lane, back to shared memory
// between the transcript's sections (nothing of it is held in registers
// through the sums).
template <class W>
OTTI_FN void zr_keep(const W& w, ZrShared& sh, const Strobe& s) {
  w.sync();
  if (w.lane == 0) sh.strobe = s;
}

// The ncom (1 or 2) commitments of sh.sc / sh.gen, nsc scalars each, summed
// over the comb table and encoded into sh.enc[slot0] (and sh.enc[slot1]).
OTTI_FN void zr_commit_encode(const ZrBlock blk, ZrShared& sh, const int32_t* table,
                                  int ncom, int nsc, int slot0, int slot1) {
  blk.pfor(ncom * ZR_SLOTS, [&](int i) {
    const int c = i / ZR_SLOTS;
    bool have = false;
    for (int k = i % ZR_SLOTS; k < nsc * ZR_NWIN; k += ZR_SLOTS) {
      const int s = k / ZR_NWIN, w = k % ZR_NWIN;
      const uint32_t digit = (sh.sc[c][s].w[w >> 2] >> (8 * (w & 3))) & 0xFFu;
      if (digit == 0) continue;  // the identity
      pt_entry(have ? sh.tmp + i : sh.pts + i,
               table + ZR_ENTRY_WORDS * ((sh.gen[c][s] * ZR_NWIN + w) * ZR_NDIG + (int)digit));
      if (have) pt_acc(sh.pts + i, sh.tmp + i);
      have = true;
    }
    if (!have) sh.pts[i] = pt_identity();
  });
  for (int h = ZR_SLOTS / 2; h >= 1; h >>= 1)
    blk.pfor(ncom * h, [&](int i) {
      Pt* p = sh.pts + (i / h) * ZR_SLOTS + i % h;
      pt_acc(p, p + h);
    });
  blk.pfor(ncom, [&](int c) { zr_encode(sh.pts + c * ZR_SLOTS, sh.enc[c ? slot1 : slot0]); });
}

template <int D>
OTTI_FN void zk_round(const ZrBlock blk, ZrShared& sh, const ZrIo& io) {
  constexpr int NC = D + 1;  // coefficients; H is generator NC of the table
  // load: the state, the coefficients (p(1) = e - p(0) inserted), d, the
  // scalars, the program's labels
  blk.pfor(KECCAK_LANES + NC + 1, [&](int i) {
    if (i < KECCAK_LANES) {
#ifdef __CUDA_ARCH__
      sh.st[i] = reinterpret_cast<const uint64_t*>(io.state)[i];
#else
      memcpy(&sh.st[i], io.state + 8 * i, 8);
#endif
      return;
    }
    i -= KECCAK_LANES;
    if (i < NC) {  // the evaluations at 0, 1, 2(, 3)
      const Fe p0 = zr_scalar(io.evs);
      sh.ev[i] = i == 0 ? p0
               : i == 1 ? fe_sub<FIELD_SCALAR>(zr_scalar(io.e), p0)
                        : zr_scalar(io.evs + OTTI_NL * (i - 1));
      sh.dv[i] = zr_scalar(io.d + OTTI_NL * i);
      return;
    }
    sh.e = zr_scalar(io.e);
    sh.be = zr_scalar(io.be);
    sh.b_poly = zr_scalar(io.b_poly);
    sh.b_next = zr_scalar(io.b_next);
    sh.r_delta = zr_scalar(io.r_delta);
    sh.r_beta = zr_scalar(io.r_beta);
    sh.strobe = {reinterpret_cast<uint8_t*>(sh.st), io.pos, io.pos_begin, io.cur_flags};
    int off = 1 + io.prog[0];
    for (int l = 0; l < ZR_LABELS; ++l) {
      sh.lab_off[l] = off;
      sh.lab_len[l] = io.prog[1 + l];
      off += io.prog[1 + l];
    }
  });

  blk.pfor(NC, [&](int i) {
    Fe acc = s_mul(zr_scalar(io.vinv + OTTI_NL * (i * NC)), sh.ev[0]);
    for (int j = 1; j < NC; ++j)
      acc = s_add(acc, s_mul(zr_scalar(io.vinv + OTTI_NL * (i * NC + j)), sh.ev[j]));
    sh.coef[i] = acc;
  });

  // group 1 (independent of every challenge): C_poly and delta
  blk.pfor(2 * (NC + 1), [&](int i) {
    const int c = i / (NC + 1), s = i % (NC + 1);
    sh.gen[c][s] = s;
    sh.sc[c][s] = s < NC ? (c ? sh.dv[s] : sh.coef[s]) : (c ? sh.r_delta : sh.b_poly);
  });
  zr_commit_encode(blk, sh, io.table, 2, NC + 1, ZR_E_POLY, ZR_E_DELTA);

  blk.warp0([&](const StrobeWarp& w) {
    Strobe s = sh.strobe;
    zr_append(w, s, sh, io.prog, ZR_L_POLY, sh.enc[ZR_E_POLY], 32);
    zr_challenge(w, s, sh, io.prog, ZR_L_R, &sh.r);
    zr_keep(w, sh, s);
  });

  // group 2: comm_eval = e_next G_0 + b_next H (Horner)
  blk.pfor(2, [&](int i) {
    if (i == 0) {
      Fe x = sh.coef[D];
      for (int k = D - 1; k >= 0; --k) x = s_add(sh.coef[k], s_mul(sh.r, x));
      sh.e_next = x;
      sh.sc[0][0] = x;
      sh.gen[0][0] = 0;
    } else {
      sh.sc[0][1] = sh.b_next;
      sh.gen[0][1] = NC;
    }
  });
  zr_commit_encode(blk, sh, io.table, 1, 2, ZR_E_EVAL, ZR_E_EVAL);

  blk.warp0([&](const StrobeWarp& w) {
    Strobe s = sh.strobe;
    zr_append(w, s, sh, io.prog, ZR_L_EVAL, sh.enc[ZR_E_EVAL], 32);
    zr_challenge(w, s, sh, io.prog, ZR_L_W0, &sh.w0);
    zr_challenge(w, s, sh, io.prog, ZR_L_W1, &sh.w1);
    // the dot-product proof's first messages (sigma.DotProductProof.prove)
    zr_append(w, s, sh, io.prog, ZR_L_PROTO, io.prog + sh.lab_off[ZR_M_DOT],
              sh.lab_len[ZR_M_DOT]);
    zr_append(w, s, sh, io.prog, ZR_L_CX, sh.enc[ZR_E_POLY], 32);
    zr_keep(w, sh, s);
  });

  // weights a_k = w0 (k ? 1 : 2) + w1 r^k; y, ry_b
  blk.pfor(NC + 2, [&](int i) {
    if (i < NC) {
      Fe rp = fe_small(1);
      for (int k = 0; k < i; ++k) rp = s_mul(rp, sh.r);
      const Fe base = i == 0 ? s_add(sh.w0, sh.w0) : sh.w0;
      sh.a[i] = s_add(base, s_mul(sh.w1, rp));
      fe_to_bytes(sh.a[i], sh.abytes[i]);
    } else if (i == NC) {
      sh.y = s_add(s_mul(sh.w0, sh.e), s_mul(sh.w1, sh.e_next));
    } else {
      sh.ry_b = s_add(s_mul(sh.w0, sh.be), s_mul(sh.w1, sh.b_next));
    }
  });
  // group 3: C_y = y G_0 + ry_b H, beta = dy G_0 + r_beta H, dy = <d, a>
  blk.pfor(4, [&](int i) {
    const int c = i >> 1, s = i & 1;  // commitment (C_y, beta), scalar (G_0, H)
    Fe v;
    if (c == 0) {
      v = s ? sh.ry_b : sh.y;
    } else if (s) {
      v = sh.r_beta;
    } else {
      v = s_mul(sh.dv[0], sh.a[0]);
      for (int k = 1; k < NC; ++k) v = s_add(v, s_mul(sh.dv[k], sh.a[k]));
    }
    sh.sc[c][s] = v;
    sh.gen[c][s] = s ? NC : 0;
  });
  zr_commit_encode(blk, sh, io.table, 2, 2, ZR_E_CY, ZR_E_BETA);

  blk.warp0([&](const StrobeWarp& w) {
    Strobe s = sh.strobe;
    zr_append(w, s, sh, io.prog, ZR_L_CY, sh.enc[ZR_E_CY], 32);
    for (int k = 0; k < NC; ++k) zr_append(w, s, sh, io.prog, ZR_L_A, sh.abytes[k], 32);
    zr_append(w, s, sh, io.prog, ZR_L_DELTA, sh.enc[ZR_E_DELTA], 32);
    zr_append(w, s, sh, io.prog, ZR_L_BETA, sh.enc[ZR_E_BETA], 32);
    zr_challenge(w, s, sh, io.prog, ZR_L_C, &sh.c);
    zr_keep(w, sh, s);
  });

  // out: the state, z = c coef + d, zdb = c (b_poly, ry_b) + (r_delta,
  // r_beta), r, e_next, the encodings
  blk.pfor(KECCAK_LANES + NC + 4 + 4 * 32, [&](int i) {
    if (i < KECCAK_LANES) {
#ifdef __CUDA_ARCH__
      reinterpret_cast<uint64_t*>(io.state)[i] = sh.st[i];
#else
      memcpy(io.state + 8 * i, &sh.st[i], 8);
#endif
      return;
    }
    i -= KECCAK_LANES;
    if (i < NC) {
      zr_store(io.z + OTTI_NL * i, s_add(s_mul(sh.c, sh.coef[i]), sh.dv[i]));
    } else if (i < NC + 2) {
      const bool second = i == NC + 1;
      zr_store(io.zdb + OTTI_NL * (i - NC),
               s_add(s_mul(sh.c, second ? sh.ry_b : sh.b_poly), second ? sh.r_beta : sh.r_delta));
    } else if (i == NC + 2) {
      zr_store(io.r, sh.r);
    } else if (i == NC + 3) {
      zr_store(io.e_next, sh.e_next);
    } else {
      const int j = i - NC - 4;
      io.encs[j] = sh.enc[j / 32][j % 32];
    }
  });
}
