// Kernel 5: one round of SPARK's custom-combination sumcheck over the SCALAR
// field, in one launch.
//
// Replaces the XLA round programs of otti_tpu/spartan/sumcheck.py:
// _custom_eval_kernel (first round), _custom_step_kernel (bind, then
// evaluate), _bind_kernel as the custom sumcheck's bare final bind, and
// the scan body of _custom_seg_kernel (the device-transcript rounds).
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
// rounds).
//
// What bounds it on an H100: by the card's peaks, bytes.  A bind and
// evaluate round with previous half ah reads 2 ah rows of each table and
// writes ah (k * 3 * ah * 88 B: 155.7 MB for the entry round at ah = 2^16,
// 0.046 ms at 3.35 TB/s), while its k ah + (ah / 2) * points * (11 or 5)
// field multiplies would take two thirds of that at the integer peak.  A
// field multiply is about a thousand machine operations, so in practice
// integer throughput holds it, as it holds kernel 2.  This is the simple
// form, kernel 2's structure without its copy engine:
//
//   * A block owns CR_P consecutive pairs: rows [i0, i0 + CR_P) at the four
//     offsets 0, h, ah, ah + h of every table.
//   * Stage 1, one thread per (table, element), 2 CR_P elements a table:
//     load the element and its partner ah rows on, canonicalise, bind,
//     write the bound limbs back over the element, keep the bound words in
//     shared memory for stage 2.
//   * Stage 2, one thread per (subterm, point, pair): the combination is a
//     sum of subterms (4 for spark_entry4, 2 for spark_table, at most 3
//     multiplies each), and a thread extends the tables its subterm reads to
//     the point from the shared words and multiplies them out.  Short
//     chains keep a thread's registers few (one thread per (point, pair)
//     doing all 11 multiplies spilled at 112 registers) and give the stage
//     four times the threads.
//   * The subterms are canonical 8-word integers.  A block adds them word by
//     word (64-bit sums, exact), adds its sums to the global accumulators
//     with integer atomics, and takes a ticket; the block with the last
//     ticket reads the accumulators, clears them and the ticket for the
//     next launch, reduces each sum mod l and writes the evaluations.
//     Integer addition is associative, so the result does not depend on
//     the order in which blocks arrive: every run gives the same bits.
//
// In place and race-free without staging: the thread of element (q, i +
// off), off in {0, h}, is the only one to read rows i + off and
// i + off + ah of table q, and the only one to write row i + off.  Since
// i < h and the offsets are multiples of h, a row index determines its
// (i, offset), so no two threads, in a block or across blocks, touch one
// row.  Rounds of fewer than CR_P pairs, down to one, mask the rest.
//
// The tensor cores have no part: these are exact 255-bit integers.
#include <string.h>

#include "device.cuh"
#include "field.cuh"

#define CR_P 16            // pairs per block
#define CR_THREADS 256     // stage 2 of spark_entry4: 4 subterms x 4 points x CR_P pairs
#define CR_MIN_BLOCKS 2    // resident blocks per SM: at most 128 registers a thread
#define CR_MAXK 9          // tables
#define CR_MAXC 4          // constants
#define CR_MAXPTS 4        // evaluation points
#define CR_MAXSUB 4        // subterms of a combination
#define CR_TICKET (CR_MAXPTS * OTTI_NW)  // index of the ticket in the scratch

typedef unsigned long long u64;

enum { COMB_ENTRY4 = 0, COMB_TABLE = 1 };

struct CustomRound {
  int32_t* tab;             // [k, n, 22]
  long long n;
  int k, comb, npts;
  Fe r;
  const int32_t* r_dev;     // when set: r as 22 limbs in device memory (any semi form)
  const int32_t* consts;    // [kc, 22], any semi form
  int kc;
  long long ah;      // bind distance (0: no bind)
  long long h;       // pair distance
  long long nlo;     // elements of the lo half to bind (and to load)
  long long npairs;  // pairs to evaluate
};

// A stored row, any semi form -> canonical words (plain 4-byte loads).
__device__ __forceinline__ Fe load_canon(const int32_t* row) {
  int32_t x[OTTI_NL];
#pragma unroll
  for (int l = 0; l < OTTI_NL; ++l) x[l] = row[l];
  return fe_canon<FIELD_SCALAR>(fe_pack(x));
}

__device__ __forceinline__ void store_row(int32_t* row, const Fe& z) {
  int32_t x[OTTI_NL];
  fe_unpack(z, x);
#pragma unroll
  for (int l = 0; l < OTTI_NL; ++l) row[l] = x[l];
}

__device__ __forceinline__ Fe fe_one() {
  Fe x;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) x.w[w] = w == 0;
  return x;
}

// Table q extended to the point t at pair i: lo + t (hi - lo), lo and hi
// being elements i and CR_P + i of its bound words in shared memory.
__device__ __forceinline__ Fe ext_at(const uint32_t (*bound)[OTTI_NW][2 * CR_P], int q,
                                     int i, int t) {
  Fe lo, hi;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) lo.w[w] = bound[q][w][i];
  if (t == 0) return lo;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) hi.w[w] = bound[q][w][CR_P + i];
  const Fe d = fe_sub<FIELD_SCALAR>(hi, lo);
  Fe x = hi;
  for (int s = 1; s < t; ++s) x = fe_add<FIELD_SCALAR>(x, d);
  return x;
}

__device__ __forceinline__ Fe cst(const uint32_t (*cw)[OTTI_NW], int c) {
  Fe x;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) x.w[w] = cw[c][w];
  return x;
}

// Subterm u of the combination at pair i, point t (canonical); the
// combination is the sum of its subterms.  Each is a short chain with one
// value live between multiplies: an extension is made again from shared
// memory where it is used (a subtraction and a few additions).
__device__ __forceinline__ Fe subterm(int comb, int u, const uint32_t (*bound)[OTTI_NW][2 * CR_P],
                                      const uint32_t (*cw)[OTTI_NW], int i, int t) {
#define X(q) ext_at(bound, q, i, t)
#define MUL fe_mul<FIELD_SCALAR>
  Fe a;
  if (comb == COMB_ENTRY4) {
    // sel, val, er, ec, eqn, invr, gr, invc, gc = X(0) .. X(8); c2..c5 = cw[0..3]
    if (u == 0) {  // sel val er ec
      a = MUL(X(0), X(1));
      a = MUL(a, X(2));
      return MUL(a, X(3));
    }
    if (u == 3) {  // c4 invr + c5 invc
      a = MUL(X(5), cst(cw, 2));
      return fe_add<FIELD_SCALAR>(a, MUL(X(7), cst(cw, 3)));
    }
    // u = 1: c2 eqn (invr gr - 1); u = 2: c3 eqn (invc gc - 1)
    const int q = u == 1 ? 5 : 7;
    a = MUL(X(q), X(q + 1));
    a = fe_sub<FIELD_SCALAR>(a, fe_one());
    a = MUL(a, X(4));
    return MUL(a, cst(cw, u - 1));
  }
  // m, invt, eqx, gt = X(0) .. X(3); c6, c7 = cw[0], cw[1]
  if (u == 0) {  // c6 m invt
    a = MUL(X(0), X(1));
    return MUL(a, cst(cw, 0));
  }
  a = fe_sub<FIELD_SCALAR>(MUL(X(1), X(3)), fe_one());  // c7 eqx (invt gt - 1)
  a = MUL(a, X(2));
  return MUL(a, cst(cw, 1));
#undef X
#undef MUL
}

__global__ void __launch_bounds__(CR_THREADS, CR_MIN_BLOCKS)
custom_round_kernel(const CustomRound rd, u64* __restrict__ scratch,
                    int32_t* __restrict__ evals) {
  __shared__ uint32_t bound[CR_MAXK][OTTI_NW][2 * CR_P];
  __shared__ uint32_t terms[CR_MAXPTS][CR_MAXSUB][OTTI_NW][CR_P];
  __shared__ uint32_t cw[CR_MAXC][OTTI_NW];
  __shared__ u64 sums[CR_MAXPTS * OTTI_NW];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * CR_P;
  const bool bind = rd.ah > 0;
  const long long tstride = rd.n * OTTI_NL;  // words from one table to the next

  // ---- stage 1: one thread per (table, element); bind, write back, keep words
  for (int idx = tid; idx < rd.k * 2 * CR_P; idx += blockDim.x) {
    const int q = idx / (2 * CR_P), slot = idx % (2 * CR_P);
    const int sg = slot / CR_P, row = slot % CR_P;
    if (i0 + row >= (sg ? rd.npairs : rd.nlo)) continue;
    int32_t* mine = rd.tab + q * tstride + (i0 + row + (sg ? rd.h : 0)) * OTTI_NL;
    Fe x = load_canon(mine);
    if (bind) {
      Fe r = rd.r;
      if (rd.r_dev) r = load_canon(rd.r_dev);  // squeezed on the card
      const Fe y = load_canon(mine + rd.ah * OTTI_NL);
      x = fe_add<FIELD_SCALAR>(x, fe_mul<FIELD_SCALAR>(r, fe_sub<FIELD_SCALAR>(y, x)));
      store_row(mine, x);
    }
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) bound[q][w][slot] = x.w[w];
  }
  if (rd.npairs == 0) return;  // bare final bind
  if (tid < rd.kc) {
    const Fe c = load_canon(rd.consts + tid * OTTI_NL);
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) cw[tid][w] = c.w[w];
  }
  __syncthreads();

  // ---- stage 2: one thread per (subterm, point, pair); a warp shares its subterm
  const int nsub = rd.comb == COMB_ENTRY4 ? 4 : 2;
  for (int idx = tid; idx < nsub * rd.npts * CR_P; idx += blockDim.x) {
    const int u = idx / (rd.npts * CR_P), e = idx / CR_P % rd.npts, i = idx % CR_P;
    const int t = e == 0 ? 0 : e + 1;  // points 0, 2, 3, ...
    Fe term;
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) term.w[w] = 0;
    if (i0 + i < rd.npairs) term = subterm(rd.comb, u, bound, cw, i, t);
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) terms[e][u][w][i] = term.w[w];
  }
  __syncthreads();

  // ---- exact word sums: block, then card; the last block finishes
  if (tid < rd.npts * OTTI_NW) {
    const int e = tid / OTTI_NW, w = tid % OTTI_NW;
    u64 s = 0;
    for (int u = 0; u < nsub; ++u)
#pragma unroll
      for (int i = 0; i < CR_P; ++i) s += terms[e][u][w][i];
    atomicAdd(&scratch[tid], s);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&scratch[CR_TICKET], 1ull) == (u64)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid < rd.npts * OTTI_NW) sums[tid] = atomicExch(&scratch[tid], 0ull);
  if (tid == 0) scratch[CR_TICKET] = 0;
  __syncthreads();
  if (tid < rd.npts) {
    // each word sum < 4 npairs * 2^32; the total < 4 npairs * l < 2^284
    uint32_t r[9];
    u64 c = 0;
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) {
      c += sums[tid * OTTI_NW + w];
      r[w] = (uint32_t)c;
      c >>= 32;
    }
    r[8] = (uint32_t)c;
    int32_t x[OTTI_NL];
    fe_unpack(scalar_canon9(r), x);
#pragma unroll
    for (int l = 0; l < OTTI_NL; ++l) evals[tid * OTTI_NL + l] = x[l];
  }
}

static int32_t g_consts[sizeof(FieldConsts) * 2 / 4];  // FieldConsts[2], for every device
static PerDevice g_devices;

// Keeps the constants on the host; each device gets them at its first
// launch (DeviceScope).
extern "C" int otti_custom_init(const int32_t* consts) {
  memcpy(g_consts, consts, sizeof(g_consts));
  return 0;
}

static int setup_device(int) { return set_field_consts(g_consts); }

// tables: [k, n, 22] int32 on the device, contiguous, updated in place.
// comb: 0 spark_entry4 (k = 9, kc = 4, 4 points), 1 spark_table (k = 4,
// kc = 2, 3 points).  consts: [kc, 22] int32 on the device.  r_host: the 8
// words of the canonical challenge in host memory, or r_dev: the challenge
// as 22 int32 limbs in device memory (a value in [0, 2^256), |limb| <
// 2^18), read by the kernel; r_dev wins when both are given; both are
// ignored when ah == 0.  ah: the previous active half (0: no bind, 1: bare
// final bind, which evaluates nothing).  half: the pair distance when
// ah == 0.  scratch: 33 uint64 on the device, zero before the first launch
// and left zero by every launch (32 accumulators and the ticket); launches
// that share it must be ordered on one stream.  evals: points * 22 int32,
// unused when ah == 1.  device: the tables' CUDA device, whose stream
// ``stream`` is.  Returns the launch's cudaGetLastError().
extern "C" int otti_custom_round(int32_t* tables, int k, long long n, int comb,
                                 const int32_t* consts, int kc, const uint32_t* r_host,
                                 const int32_t* r_dev, long long ah, long long half,
                                 u64* scratch, int32_t* evals, int device, void* stream) {
  const int want_k = comb == COMB_ENTRY4 ? 9 : 4, want_kc = comb == COMB_ENTRY4 ? 4 : 2;
  if ((comb != COMB_ENTRY4 && comb != COMB_TABLE) || k != want_k || kc != want_kc ||
      ah < 0 || n < 2 || 2 * ah > n)
    return (int)cudaErrorInvalidValue;
  CustomRound rd;
  rd.tab = tables;
  rd.n = n;
  rd.k = k;
  rd.comb = comb;
  rd.npts = comb == COMB_ENTRY4 ? 4 : 3;
  for (int w = 0; w < OTTI_NW; ++w) rd.r.w[w] = ah > 0 && r_host ? r_host[w] : 0u;
  rd.r_dev = ah > 0 ? r_dev : nullptr;
  rd.consts = consts;
  rd.kc = kc;
  rd.ah = ah;
  rd.h = ah > 0 ? ah / 2 : half;
  rd.npairs = rd.h;
  rd.nlo = ah == 1 ? 1 : rd.h;
  if (rd.nlo <= 0 || (ah == 0 && 2 * half > n)) return (int)cudaErrorInvalidValue;
  const long long blocks = (rd.nlo + CR_P - 1) / CR_P;
  DeviceScope scope(device, g_devices, setup_device);
  if (scope.err) return scope.err;
  custom_round_kernel<<<(unsigned)blocks, CR_THREADS, 0, (cudaStream_t)stream>>>(
      rd, scratch, evals);
  return (int)cudaGetLastError();
}
