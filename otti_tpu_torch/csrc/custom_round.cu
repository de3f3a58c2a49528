// Kernel 5: one round of SPARK's custom-combination sumcheck over the SCALAR
// field, in one launch; in its fused entry, with the round's transcript step.
//
// Replaces the XLA round programs of otti_tpu/spartan/sumcheck.py:
// _custom_eval_kernel (first round), _custom_step_kernel (bind, then
// evaluate), _bind_kernel as the custom sumcheck's bare final bind, and
// the scan body of _custom_seg_kernel (the device-transcript rounds: the
// fused entry).
//
// The k tables lie stacked, [k, n, 22] int32 limbs.  A launch binds the
// previous challenge r into the active prefix of every table,
// t[j] <- t[j] + r * (t[j + ah] - t[j]) for j < ah (ah: the previous active
// half), and then evaluates the round polynomial over the pairs
// (t[i], t[i + h]), i < h = ah / 2, at the points t in {0, 2, ..., degree}:
// the sum over i of a combination of the tables' extensions
// X_t = lo + t * (hi - lo) and a few constants.  ah == 0 is the first
// round (no bind, pairs (i, i + half)); ah == 1 is the bare final bind
// (row 0 only, no evaluation).  The combinations are the SPARK layer's
// (otti_tpu/spartan/spark.py::_comb_entry, _comb_table), selected by id:
//   0 spark_entry4, 9 tables (sel, val, er, ec, eqn, invr, gr, invc, gc),
//     4 consts, degree 4:
//     sel val er ec + c2 eqn (invr gr - 1) + c3 eqn (invc gc - 1)
//       + c4 invr + c5 invc
//   1 spark_table, 4 tables (m, invt, eqx, gt), 2 consts, degree 3:
//     c6 m invt + c7 eqx (invt gt - 1)
//
// The challenge comes by value from the host, or from device memory where
// the device transcript squeezed it (then no host sync stands between two
// rounds).  The fused entry (otti_custom_round_fs) squeezes it itself: after
// its ticket the last block absorbs the evaluations into the device
// transcript's 200-byte state, append_message(label/e_p, 32 LE bytes) for
// each point p, squeezes challenge_bytes(label/r, 64), reduces the bytes
// mod l and writes the challenge where the next launch's bind reads it
// (csrc/strobe.cuh in one warp, on keccak.cuh's permutation).  A device
// round is then one launch.  Every round of a sumcheck starts and ends at
// the same STROBE offsets (the post-challenge ones), so the step is a fixed
// byte program of the labels, whatever the round; the host checks that once
// a sumcheck.
//
// What bounds it on an H100: by the card's peaks, bytes.  A bind and
// evaluate round with previous half ah reads 2 ah rows of each table and
// writes ah (k * 3 * ah * 88 B: 155.7 MB for the entry round at ah = 2^16,
// 0.046 ms at 3.35 TB/s), while its k ah + (ah / 2) * points * (7 or 3)
// field multiplies take less at the integer peak.  A field multiply is
// about a thousand machine operations, so integer throughput is near as
// tight.  The design:
//
//   * A block owns CR_P = 16 consecutive pairs: rows [i0, i0 + 16) at the
//     four offsets 0, h, ah, ah + h of each table, 4 k segments of 1,408
//     contiguous bytes (50,688 B for spark_entry4).  One thread asks the
//     copy engine for all of them (cp.async.bulk on one mbarrier,
//     async_copy.cuh) into dynamic shared memory above 48 KB.  16 pairs
//     rather than 8 halve the blocks, and with them the atomics of the
//     cross-block sums, for the same occupancy (2 blocks an SM for
//     spark_entry4, registers and shared memory alike).
//   * Stage 1, one thread per (table, element): pack to words, canonicalise
//     only rows this kernel did not write (the first round and the first
//     bind; the host passes that flag: every later round reads rows the
//     previous launch wrote canonical), bind, write the bound limbs over
//     the loaded row; bulk stores send the bound lo segments back while
//     the stages below run.
//   * Extensions, one thread per (table, pair): d = hi - lo once, then
//     X_t = X_{t-1} + d up to the degree, kept in shared memory.
//   * Stage 2, one thread per (product, point, pair): the combination's
//     products without its constants (spark_entry4: sel val er ec,
//     eqn (invr gr - 1), eqn (invc gc - 1), 3 + 2 + 2 multiplies;
//     spark_table: m invt, eqx (invt gt - 1), 1 + 2).  The constants
//     distribute over the sum across pairs, so they are applied once a
//     point, by the last block.
//   * Each point has its own exact sums (64-bit word sums): the products,
//     and for spark_entry4 the bare extensions invr_t and invc_t.  A block
//     adds its sums to the global accumulators with integer atomics and
//     takes a ticket; the block with the last ticket reads the
//     accumulators, clears them and the ticket for the next launch,
//     reduces each sum mod l and forms S0 + c2 S1 + c3 S2 + c4 S3 + c5 S4
//     (spark_entry4) or c6 S0 + c7 S1 (spark_table): 4 or 2 multiplies a
//     point.  Integer addition is associative, so the result does not
//     depend on the order in which blocks arrive: every run gives the same
//     bits.
//   * Tables of fewer than 16 pairs (the last rounds), a ragged size or a
//     pointer that is not 16-byte aligned take the same path with plain
//     masked loads and stores by all threads; so does the bare final bind.
//
// In place and race-free: every position is read into shared memory (the
// barrier after the load) before any thread of the block writes a table,
// and no other block touches those rows: block i0 reads rows i0 + [0, 16)
// + {0, h, ah, ah + h} and writes those at + {0, h}; since i < h and the
// offsets are multiples of h, a row index determines its (i, offset), so
// the row sets of two blocks are disjoint.
//
// The tensor cores have no part: these are exact 255-bit integers.
#include <string.h>

#include "async_copy.cuh"
#include "device.cuh"
#include "field.cuh"
#include "strobe.cuh"

#define CR_P 16            // pairs per block
#define CR_MAXPTS 4        // evaluation points
#define CR_MAXSUMS 5       // sums a point
#define CR_SEG_WORDS (CR_P * OTTI_NL)
#define CR_SEG_BYTES (CR_SEG_WORDS * 4)
#define CR_SUM_WORDS (CR_MAXPTS * CR_MAXSUMS * OTTI_NW)  // the accumulators: [point][sum][word]
#define CR_TICKET CR_SUM_WORDS  // index of the ticket in the scratch
#define CR_MAXPROG 256     // bytes of a round's labels (strobe.cuh's merlin_round)

typedef unsigned long long u64;

enum { COMB_ENTRY4 = 0, COMB_TABLE = 1 };

// A combination's shape.  Sums s < NPROD are products of extensions (stage
// 2); the others are one table's bare extension (direct_table(s)).  A block
// has K * 2 CR_P threads (stage 1: one per element); MIN_BLOCKS: resident
// blocks an SM that the registers must allow (at most 112 and 128 a thread).
template <int COMB>
struct Comb;
template <>
struct Comb<COMB_ENTRY4> {
  enum { K = 9, KC = 4, NPTS = 4, NSUMS = 5, NPROD = 3, MIN_BLOCKS = 2 };
};
template <>
struct Comb<COMB_TABLE> {
  enum { K = 4, KC = 2, NPTS = 3, NSUMS = 2, NPROD = 2, MIN_BLOCKS = 4 };
};

template <int COMB>
struct Smem {
  enum { K = Comb<COMB>::K, NPTS = Comb<COMB>::NPTS, NSUMS = Comb<COMB>::NSUMS };
  // segment sg of table q: row offset (sg & 1 ? h : 0) + (sg & 2 ? ah : 0)
  int32_t raw[K][4][CR_SEG_WORDS];
  uint32_t x[K][NPTS + 1][OTTI_NW][CR_P];  // X_0 = lo, X_1 = hi, X_2 .. X_degree
  uint32_t terms[NPTS][Comb<COMB>::NPROD][OTTI_NW][CR_P];
  u64 sums[NPTS * NSUMS * OTTI_NW];
  uint32_t cw[Comb<COMB>::KC][OTTI_NW];
  uint32_t sfe[NPTS][NSUMS][OTTI_NW];  // the last block's sums mod l
  uint32_t evw[NPTS][OTTI_NW];         // its evaluations, as the transcript absorbs them
  uint64_t st[KECCAK_LANES];           // the transcript's state (fused entry)
  uint8_t prog[CR_MAXPROG];            // its labels
  uint8_t out64[64];
  uint64_t bar;
  int is_last;
};

struct CustomRound {
  int32_t* tab;             // [k, n, 22]
  long long n;
  Fe r;
  const int32_t* r_dev;     // when set: r as 22 limbs in device memory (any semi form)
  const int32_t* consts;    // [kc, 22], any semi form
  long long ah;      // bind distance (0: no bind)
  long long h;       // pair distance
  long long nlo;     // rows of the lo segments that exist
  long long npairs;  // pairs to evaluate (= rows of the hi segments)
  int canon;         // rows read may be in semi form: canonicalise them
  int bulk;
};

// The fused entry's transcript step.
struct RoundFS {
  uint8_t* state;        // uint8[200], updated in place
  const uint8_t* prog;   // the round's labels (strobe.cuh's merlin_round)
  int prog_len;          // its bytes, at most CR_MAXPROG
  int pos, pos_begin, flags;  // the state's offsets, at the start and the end of the step
  int32_t* r_out;        // [22]: the challenge, canonical
};

// A row in device memory at any 4-byte alignment, any semi form -> canonical.
__device__ __forceinline__ Fe load_canon(const int32_t* row) {
  int32_t x[OTTI_NL];
#pragma unroll
  for (int l = 0; l < OTTI_NL; ++l) x[l] = row[l];
  return fe_canon<FIELD_SCALAR>(fe_pack(x));
}

__device__ __forceinline__ Fe words_at(const uint32_t (*v)[CR_P], int i) {
  Fe x;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) x.w[w] = v[w][i];
  return x;
}

__device__ __forceinline__ Fe row_words(const uint32_t* v) {
  Fe x;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) x.w[w] = v[w];
  return x;
}

__device__ __forceinline__ void put_words(uint32_t (*v)[CR_P], int i, const Fe& x) {
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) v[w][i] = x.w[w];
}

__device__ __forceinline__ Fe fe_one() {
  Fe x;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) x.w[w] = w == 0;
  return x;
}

// Product s of the combination at pair i and extension slot t (canonical).
template <int COMB>
__device__ __forceinline__ Fe product(const Smem<COMB>& S, int s, int i, int t) {
#define X(q) words_at(S.x[q][t], i)
#define MUL fe_mul<FIELD_SCALAR>
  if constexpr (COMB == COMB_ENTRY4) {
    // sel, val, er, ec, eqn, invr, gr, invc, gc = X(0) .. X(8)
    if (s == 0) return MUL(MUL(MUL(X(0), X(1)), X(2)), X(3));  // sel val er ec
    const int q = s == 1 ? 5 : 7;  // eqn (invr gr - 1), eqn (invc gc - 1)
    return MUL(X(4), fe_sub<FIELD_SCALAR>(MUL(X(q), X(q + 1)), fe_one()));
  } else {
    // m, invt, eqx, gt = X(0) .. X(3)
    if (s == 0) return MUL(X(0), X(1));                                   // m invt
    return MUL(X(2), fe_sub<FIELD_SCALAR>(MUL(X(1), X(3)), fe_one()));  // eqx (invt gt - 1)
  }
#undef X
#undef MUL
}

// The table whose bare extension is sum s (s >= NPROD): invr, invc.
__device__ __forceinline__ int direct_table(int s) { return s == 3 ? 5 : 7; }

// The point's evaluation from its sums mod l and the constants.
template <int COMB>
__device__ __forceinline__ Fe combine(const Smem<COMB>& S, int e) {
#define SUM(s) row_words(S.sfe[e][s])
#define CST(c) row_words(S.cw[c])
#define MUL fe_mul<FIELD_SCALAR>
#define ADD fe_add<FIELD_SCALAR>
  if constexpr (COMB == COMB_ENTRY4) {  // S0 + c2 S1 + c3 S2 + c4 S3 + c5 S4
    Fe a = ADD(SUM(0), MUL(CST(0), SUM(1)));
    a = ADD(a, MUL(CST(1), SUM(2)));
    a = ADD(a, MUL(CST(2), SUM(3)));
    return ADD(a, MUL(CST(3), SUM(4)));
  } else {
    return ADD(MUL(CST(0), SUM(0)), MUL(CST(1), SUM(1)));  // c6 S0 + c7 S1
  }
#undef SUM
#undef CST
#undef MUL
#undef ADD
}

template <int COMB, bool FS>
__global__ void __launch_bounds__(Comb<COMB>::K * 2 * CR_P, Comb<COMB>::MIN_BLOCKS)
custom_round_kernel(const CustomRound rd, const RoundFS fs, u64* __restrict__ scratch,
                    int32_t* __restrict__ evals) {
  typedef Comb<COMB> C;
  enum { THREADS = C::K * 2 * CR_P };
  static_assert(C::NPROD * C::NPTS * CR_P <= THREADS && C::NPTS * C::NSUMS <= THREADS &&
                THREADS >= 32, "a stage has more threads than the block");
  extern __shared__ __align__(128) uint8_t smem_bytes[];
  Smem<COMB>& S = *reinterpret_cast<Smem<COMB>*>(smem_bytes);

  const int tid = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * CR_P;
  const bool bind = rd.ah > 0;
  const int nseg = bind ? 4 : 2;
  const long long tstride = rd.n * OTTI_NL;  // words from one table to the next
#define TAB(q) (rd.tab + (q) * tstride)

  // ---- load the block's segments into shared memory
  if (rd.bulk) {
    if (tid == 0) {
      mbar_init(&S.bar, 1);
      mbar_init_fence();
      mbar_expect(&S.bar, (uint32_t)(C::K * nseg * CR_SEG_BYTES));
      for (int q = 0; q < C::K; ++q)
        for (int sg = 0; sg < nseg; ++sg) {
          const long long row = i0 + (sg & 1 ? rd.h : 0) + (sg & 2 ? rd.ah : 0);
          bulk_load(S.raw[q][sg], TAB(q) + row * OTTI_NL, CR_SEG_BYTES, &S.bar);
        }
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    mbar_wait(&S.bar, 0);
  } else {
    for (int idx = tid; idx < C::K * nseg * CR_SEG_WORDS; idx += THREADS) {
      const int q = idx / (nseg * CR_SEG_WORDS), rem = idx % (nseg * CR_SEG_WORDS);
      const int sg = rem / CR_SEG_WORDS, w = rem % CR_SEG_WORDS;
      const long long i = i0 + w / OTTI_NL;
      if (i < (sg & 1 ? rd.npairs : rd.nlo)) {
        const long long row = i + (sg & 1 ? rd.h : 0) + (sg & 2 ? rd.ah : 0);
        S.raw[q][sg][w] = TAB(q)[row * OTTI_NL + w % OTTI_NL];
      }
    }
    __syncthreads();
  }

  // ---- stage 1: one thread per (table, element); bind, keep words, restage limbs
  {
    const int q = tid / (2 * CR_P), slot = tid % (2 * CR_P);
    const int sg = slot / CR_P, row = slot % CR_P;
    if (i0 + row < (sg ? rd.npairs : rd.nlo)) {
      int32_t* mine = S.raw[q][sg] + row * OTTI_NL;
      Fe x = fe_load_row(mine);
      if (rd.canon) x = fe_canon<FIELD_SCALAR>(x);
      if (bind) {
        const Fe r = rd.r_dev ? load_canon(rd.r_dev) : rd.r;  // squeezed on the card, or by value
        Fe y = fe_load_row(S.raw[q][sg + 2] + row * OTTI_NL);
        if (rd.canon) y = fe_canon<FIELD_SCALAR>(y);
        x = fe_add<FIELD_SCALAR>(x, fe_mul<FIELD_SCALAR>(r, fe_sub<FIELD_SCALAR>(y, x)));
        fe_store_row(mine, x);
      }
      put_words(S.x[q][sg], row, x);
    }
  }
  if (tid < C::KC) {
    const Fe c = load_canon(rd.consts + tid * OTTI_NL);
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) S.cw[tid][w] = c.w[w];
  }
  if (bind && rd.bulk) async_proxy_fence();
  __syncthreads();

  // ---- bound rows go back to the tables (under the stages below when by bulk store)
  if (bind) {
    if (rd.bulk) {
      if (tid == 0) {
        for (int q = 0; q < C::K; ++q)
          for (int sg = 0; sg < 2; ++sg)
            bulk_store(TAB(q) + (i0 + (sg ? rd.h : 0)) * OTTI_NL, S.raw[q][sg], CR_SEG_BYTES);
        bulk_commit();
      }
    } else {
      for (int idx = tid; idx < C::K * 2 * CR_SEG_WORDS; idx += THREADS) {
        const int q = idx / (2 * CR_SEG_WORDS), rem = idx % (2 * CR_SEG_WORDS);
        const int sg = rem / CR_SEG_WORDS, w = rem % CR_SEG_WORDS;
        const long long i = i0 + w / OTTI_NL;
        if (i < (sg ? rd.npairs : rd.nlo))
          TAB(q)[(i + (sg ? rd.h : 0)) * OTTI_NL + w % OTTI_NL] = S.raw[q][sg][w];
      }
    }
  }
  if (rd.npairs == 0) return;  // bare final bind (never by bulk store)
  const int nvalid = rd.npairs - i0 < CR_P ? (int)(rd.npairs - i0) : CR_P;

  // ---- extensions: one thread per (table, pair)
  if (tid < C::K * CR_P) {
    const int q = tid / CR_P, i = tid % CR_P;
    if (i < nvalid) {
      Fe x = words_at(S.x[q][1], i);
      const Fe d = fe_sub<FIELD_SCALAR>(x, words_at(S.x[q][0], i));
#pragma unroll
      for (int t = 2; t <= C::NPTS; ++t) {
        x = fe_add<FIELD_SCALAR>(x, d);
        put_words(S.x[q][t], i, x);
      }
    }
  }
  __syncthreads();

  // ---- stage 2: one thread per (product, point, pair)
  if (tid < C::NPROD * C::NPTS * CR_P) {
    const int s = tid / (C::NPTS * CR_P), e = tid / CR_P % C::NPTS, i = tid % CR_P;
    if (i < nvalid) put_words(S.terms[e][s], i, product<COMB>(S, s, i, e == 0 ? 0 : e + 1));
  }
  __syncthreads();

  // ---- exact word sums: block, then card; the last block finishes
  for (int idx = tid; idx < C::NPTS * C::NSUMS * OTTI_NW; idx += THREADS) {
    const int e = idx / (C::NSUMS * OTTI_NW), s = idx / OTTI_NW % C::NSUMS, w = idx % OTTI_NW;
    const uint32_t* col = S.terms[e][s < C::NPROD ? s : 0][w];
    if constexpr (C::NSUMS > C::NPROD)
      if (s >= C::NPROD) col = S.x[direct_table(s)][e == 0 ? 0 : e + 1][w];
    u64 sum = 0;
    for (int i = 0; i < nvalid; ++i) sum += col[i];
    atomicAdd(&scratch[(e * CR_MAXSUMS + s) * OTTI_NW + w], sum);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) S.is_last = atomicAdd(&scratch[CR_TICKET], 1ull) == (u64)gridDim.x - 1;
  __syncthreads();
  if (!S.is_last) {
    if (rd.bulk && bind && tid == 0) bulk_wait_all();
    return;
  }
  for (int idx = tid; idx < C::NPTS * C::NSUMS * OTTI_NW; idx += THREADS) {
    const int e = idx / (C::NSUMS * OTTI_NW), s = idx / OTTI_NW % C::NSUMS, w = idx % OTTI_NW;
    S.sums[idx] = atomicExch(&scratch[(e * CR_MAXSUMS + s) * OTTI_NW + w], 0ull);
  }
  if (tid == 0) scratch[CR_TICKET] = 0;
  if (FS) {  // the state and the labels into shared memory, for the warp's byte steps
    for (int b = tid; b < 200; b += THREADS) reinterpret_cast<uint8_t*>(S.st)[b] = fs.state[b];
    for (int b = tid; b < fs.prog_len; b += THREADS) S.prog[b] = fs.prog[b];
  }
  __syncthreads();
  if (tid < C::NPTS * C::NSUMS) {
    // each word sum < npairs * 2^32; the total < npairs * l < 2^284
    uint32_t r[9];
    u64 c = 0;
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) {
      c += S.sums[tid * OTTI_NW + w];
      r[w] = (uint32_t)c;
      c >>= 32;
    }
    r[8] = (uint32_t)c;
    const Fe v = scalar_canon9(r);
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) S.sfe[tid / C::NSUMS][tid % C::NSUMS][w] = v.w[w];
  }
  __syncthreads();
  if (tid < C::NPTS) {
    const Fe ev = combine<COMB>(S, tid);
    int32_t x[OTTI_NL];
    fe_unpack(ev, x);
#pragma unroll
    for (int l = 0; l < OTTI_NL; ++l) evals[tid * OTTI_NL + l] = x[l];
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) S.evw[tid][w] = ev.w[w];
  }
  if (FS) {
    __syncthreads();
    // One warp runs the round's Merlin step; the others leave first, so that
    // its shuffles run as straight-line code of one converged warp (warp 0
    // holds thread 0, which waits for the bulk stores below).
    if (tid >= 32) return;
    const StrobeWarp w(tid);
    Strobe st = {reinterpret_cast<uint8_t*>(S.st), fs.pos, fs.pos_begin, fs.flags};
    merlin_round(w, st, S.prog, reinterpret_cast<const uint8_t*>(S.evw), S.out64);
    for (int b = tid; b < 200; b += 32) fs.state[b] = reinterpret_cast<uint8_t*>(S.st)[b];
    if (tid == 0) {
      int32_t x[OTTI_NL];
      fe_unpack(scalar_from_le64(S.out64), x);
#pragma unroll
      for (int l = 0; l < OTTI_NL; ++l) fs.r_out[l] = x[l];
    }
  }
  if (rd.bulk && bind && tid == 0) bulk_wait_all();
#undef TAB
}

static int32_t g_consts[sizeof(FieldConsts) * 2 / 4];  // FieldConsts[2], for every device
static PerDevice g_devices;

// Keeps the constants on the host; each device gets them at its first
// launch (DeviceScope).
extern "C" int otti_custom_init(const int32_t* consts) {
  memcpy(g_consts, consts, sizeof(g_consts));
  return 0;
}

// The four kernels take their shared memory dynamically (above 48 KB for
// spark_entry4): each device allows it once.
template <int COMB, bool FS>
static int allow_smem() {
  return (int)cudaFuncSetAttribute(custom_round_kernel<COMB, FS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)sizeof(Smem<COMB>));
}

static int setup_device(int) {
  int err = set_field_consts(g_consts);
  if (!err) err = allow_smem<COMB_ENTRY4, false>();
  if (!err) err = allow_smem<COMB_ENTRY4, true>();
  if (!err) err = allow_smem<COMB_TABLE, false>();
  if (!err) err = allow_smem<COMB_TABLE, true>();
  return err;
}

template <int COMB, bool FS>
static void launch(unsigned blocks, const CustomRound& rd, const RoundFS& fs, u64* scratch,
                   int32_t* evals, cudaStream_t stream) {
  custom_round_kernel<COMB, FS><<<blocks, Comb<COMB>::K * 2 * CR_P, sizeof(Smem<COMB>), stream>>>(
      rd, fs, scratch, evals);
}

static int round_launch(int32_t* tables, int k, long long n, int comb, const int32_t* consts,
                        int kc, const uint32_t* r_host, const int32_t* r_dev, long long ah,
                        long long half, int canon, u64* scratch, int32_t* evals,
                        const RoundFS* fs, int device, void* stream) {
  const int want_k = comb == COMB_ENTRY4 ? 9 : 4, want_kc = comb == COMB_ENTRY4 ? 4 : 2;
  if ((comb != COMB_ENTRY4 && comb != COMB_TABLE) || k != want_k || kc != want_kc ||
      ah < 0 || n < 2 || 2 * ah > n)
    return (int)cudaErrorInvalidValue;
  CustomRound rd;
  rd.tab = tables;
  rd.n = n;
  for (int w = 0; w < OTTI_NW; ++w) rd.r.w[w] = ah > 0 && r_host ? r_host[w] : 0u;
  rd.r_dev = ah > 0 ? r_dev : nullptr;
  rd.consts = consts;
  rd.ah = ah;
  rd.h = ah > 0 ? ah / 2 : half;
  rd.npairs = rd.h;
  rd.nlo = ah == 1 ? 1 : rd.h;
  rd.canon = canon;
  if (rd.nlo <= 0 || (ah == 0 && 2 * half > n)) return (int)cudaErrorInvalidValue;
  if (fs && (rd.npairs == 0 || !evals)) return (int)cudaErrorInvalidValue;
  rd.bulk = ((uintptr_t)tables & 15) == 0 && rd.npairs > 0 && rd.npairs % CR_P == 0;
  const long long blocks = (rd.nlo + CR_P - 1) / CR_P;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device, g_devices, setup_device);
  if (scope.err) return scope.err;
  const RoundFS none = {nullptr, nullptr, 0, 0, 0, 0, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (comb == COMB_ENTRY4) {
    if (fs) launch<COMB_ENTRY4, true>((unsigned)blocks, rd, *fs, scratch, evals, st);
    else launch<COMB_ENTRY4, false>((unsigned)blocks, rd, none, scratch, evals, st);
  } else {
    if (fs) launch<COMB_TABLE, true>((unsigned)blocks, rd, *fs, scratch, evals, st);
    else launch<COMB_TABLE, false>((unsigned)blocks, rd, none, scratch, evals, st);
  }
  return (int)cudaGetLastError();
}

// tables: [k, n, 22] int32 on the device, contiguous, updated in place.
// comb: 0 spark_entry4 (k = 9, kc = 4, 4 points), 1 spark_table (k = 4,
// kc = 2, 3 points).  consts: [kc, 22] int32 on the device.  r_host: the 8
// words of the canonical challenge in host memory, or r_dev: the challenge
// as 22 int32 limbs in device memory (a value in [0, 2^256), |limb| <
// 2^18), read by the kernel; r_dev wins when both are given; both are
// ignored when ah == 0.  ah: the previous active half (0: no bind, 1: bare
// final bind, which evaluates nothing).  half: the pair distance when
// ah == 0.  canon: 1 when the rows read may be in any semi form (the first
// round and the first bind), 0 when the previous launch wrote them (then
// they are canonical).  scratch: 161 uint64 on the device, zero before the
// first launch and left zero by every launch (160 accumulators and the
// ticket); launches that share it must be ordered on one stream.  evals:
// points * 22 int32, unused when ah == 1.  device: the tables' CUDA device,
// whose stream ``stream`` is.  Returns the launch's cudaGetLastError().
extern "C" int otti_custom_round(int32_t* tables, int k, long long n, int comb,
                                 const int32_t* consts, int kc, const uint32_t* r_host,
                                 const int32_t* r_dev, long long ah, long long half, int canon,
                                 u64* scratch, int32_t* evals, int device, void* stream) {
  return round_launch(tables, k, n, comb, consts, kc, r_host, r_dev, ah, half, canon, scratch,
                      evals, nullptr, device, stream);
}

// otti_custom_round, and then the round's transcript step in the last
// block: state (uint8[200] on the device, any alignment) at the offsets
// pos, pos_begin, flags absorbs the evaluations under the labels of prog
// (prog_len <= 256 device bytes, strobe.cuh's merlin_round) and squeezes
// the challenge,
// which goes canonical into r_out (22 int32 on the device; the next
// launch's r_dev).  Every round evaluates (ah != 1).
extern "C" int otti_custom_round_fs(int32_t* tables, int k, long long n, int comb,
                                    const int32_t* consts, int kc, const uint32_t* r_host,
                                    const int32_t* r_dev, long long ah, long long half,
                                    int canon, u64* scratch, int32_t* evals, uint8_t* state,
                                    const uint8_t* prog, int prog_len, int pos, int pos_begin,
                                    int flags, int32_t* r_out, int device, void* stream) {
  if (!state || !prog || !r_out || prog_len < 1 || prog_len > CR_MAXPROG || pos < 0 ||
      pos >= STROBE_RATE)
    return (int)cudaErrorInvalidValue;
  const RoundFS fs = {state, prog, prog_len, pos, pos_begin, flags, r_out};
  return round_launch(tables, k, n, comb, consts, kc, r_host, r_dev, ah, half, canon, scratch,
                      evals, &fs, device, stream);
}
