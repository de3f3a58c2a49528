// Kernel 2: one fused sumcheck round over the SCALAR field, in one launch.
//
// Replaces otti_tpu/spartan/pallas_sumcheck.py::_round_kernel (entered
// through _step_call / step_cubic_pallas) and, beyond it, every XLA round
// form the provers run: sumcheck._step_cubic_kernel, _step_quad_kernel,
// _round_cubic_kernel / _round_quad_kernel (first round, no bind) and
// _bind_kernel (the bare final bind).
//
// The challenge comes by value from the host, or from device memory where
// the device transcript squeezed it (then no host sync stands between two
// rounds).
//
// A launch binds the previous challenge r into the active prefix of every
// table, t[j] <- t[j] + r * (t[j + ah] - t[j]) for j < ah (ah: the previous
// active half), and then evaluates the round polynomial over the pairs
// (t[i], t[i + h]), i < h = ah / 2:
//   cubic (4 tables eq, A, B, C): sum eq_t * (A_t * B_t - C_t), t in {0,2,3}
//   quad  (2 tables M, Z):        sum M_t * Z_t,                t in {0,2}
// with X_t = lo + t * (hi - lo).  ah == 0 is the first round (no bind, pairs
// (i, i + half)); ah == 1 is the bare final bind (row 0 only, no evaluation).
//
// What bounds it on an H100: by the card's peaks, bytes: a cubic round on
// tables of n rows reads 4 n rows of 88 B and writes 2 n (17.3 MB at n = 2^15,
// 0.005 ms at 3.35 TB/s), while the wide multiplies of its 3.5 n field
// multiplies would take a third of that at the integer peak.  What holds it
// in practice is integer throughput all the same: carries, packing,
// canonicalisations and conditional subtractions make a field multiply about
// a thousand machine operations, and the SMs run near two integer warp
// operations a clock through a round.  So the design spreads the multiplies
// over as many threads as the round has, and keeps memory out of their way:
//
//   * A block owns 16 consecutive pairs: rows [i0, i0 + 16) at the four
//     offsets 0, h, ah, ah + h of each table, 16 segments of 1,408
//     contiguous bytes in the cubic round.  One thread asks the copy engine
//     for all of them (cp.async.bulk on one mbarrier).
//   * Stage 1, one thread per bound element (4 tables x 32 elements = 128
//     threads, one multiply each): pack to words, canonicalise, bind, keep
//     the bound words in shared memory for stage 2, and write the bound
//     limbs over the thread's own row of the loaded tile; bulk stores send
//     the 8 bound segments back while stage 2 runs.
//   * Stage 2, one thread per (pair, point): read the bound words of its
//     pair, extend to the point, two multiplies (cubic) or one (quad).
//   * The terms are canonical 8-word integers.  A block adds them word by
//     word (64-bit sums, exact), adds its sums to 24 global accumulators
//     with integer atomics, and takes a ticket; the block with the last
//     ticket reads the accumulators, clears them and the ticket for the
//     next launch, reduces each sum mod l and writes the evaluations.
//     Integer addition is associative, so the result does not depend on the
//     order in which blocks arrive: every run gives the same bits.
//   * Tables of fewer than 16 pairs (the last rounds), a ragged size, or a
//     pointer that is not 16-byte aligned take the same path with plain
//     masked loads and stores by all threads.
//
// In place and race-free: every position is read into shared memory (the
// barrier after the load) before any thread of the block writes a table,
// and no other block touches those rows: block i0 reads rows i0 + [0, 16)
// + {0, h, ah, ah + h} and writes those at + {0, h}; since i < h and the
// offsets are multiples of h, a row index determines its (i, offset), so
// the row sets of two blocks are disjoint.
//
// B instances of one size (spartan/batched.py) run in one launch: the grid's
// y index is the instance, whose tables, challenge, accumulators, ticket
// and evaluations lie at its own offsets, so each instance's last block
// finishes its own sums, exactly as a launch on that instance alone would.
//
// The tensor cores have no part: these are exact 255-bit integers.
#include <string.h>

#include "async_copy.cuh"
#include "device.cuh"
#include "field.cuh"

#define SC_P 16          // pairs per block
#define SC_MIN_BLOCKS 4  // resident blocks per SM the register count must allow
#define SC_THREADS (8 * SC_P)  // stage 1: 4 tables x 2 SC_P elements
#define SC_SEG_WORDS (SC_P * OTTI_NL)
#define SC_SEG_BYTES (SC_SEG_WORDS * 4)
#define SC_MAXK 3
#define SC_TICKET (SC_MAXK * OTTI_NW)  // index of the ticket in the scratch

typedef unsigned long long u64;

// A stored row, any semi form -> canonical words.
__device__ __forceinline__ Fe load_canon(const int32_t* row) {
  return fe_canon<FIELD_SCALAR>(fe_load_row(row));
}

// X_t = lo + t * (hi - lo) for t in {0, 2, 3}, lo and hi being elements i
// and SC_P + i of one table's bound words in shared memory.
__device__ __forceinline__ Fe ext_point(const uint32_t (*tab)[2 * SC_P], int i, int t) {
  Fe lo, hi;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) lo.w[w] = tab[w][i];
  if (t == 0) return lo;
#pragma unroll
  for (int w = 0; w < OTTI_NW; ++w) hi.w[w] = tab[w][SC_P + i];
  const Fe d = fe_sub<FIELD_SCALAR>(hi, lo);
  Fe x = fe_add<FIELD_SCALAR>(lo, fe_add<FIELD_SCALAR>(d, d));
  if (t == 3) x = fe_add<FIELD_SCALAR>(x, d);
  return x;
}

// Segment sg of a block: row offset (sg & 1 ? h : 0) + (sg & 2 ? ah : 0);
// its rows are the hi halves of pairs when sg & 1, else the lo halves.
struct Round {
  int32_t* tab[4];       // instance 0's tables
  int64_t inst_words;    // words from one instance's table to the next (n * 22)
  int ntab;
  Fe r;
  const int32_t* r_dev;  // when set: r as 22 limbs in device memory (any semi form)
  int r_stride;          // words from one instance's r_dev to the next (0: shared)
  int64_t ah;      // bind distance (0: no bind)
  int64_t h;       // pair distance
  int64_t nlo;     // rows of the lo segments that exist
  int64_t npairs;  // pairs to evaluate (= rows of the hi segments)
  int bulk;
};

__global__ void __launch_bounds__(SC_THREADS, SC_MIN_BLOCKS)
sumcheck_round_kernel(const Round rd, u64* __restrict__ scratch_all,
                      int32_t* __restrict__ evals_all) {
  __shared__ __align__(128) int32_t raw[4][4][SC_SEG_WORDS];
  __shared__ uint32_t bound[4][OTTI_NW][2 * SC_P];
  __shared__ uint32_t terms[SC_MAXK][OTTI_NW][SC_P];
  __shared__ u64 sums[SC_MAXK * OTTI_NW];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * SC_P;
  const bool bind = rd.ah > 0;
  const int nseg = bind ? 4 : 2;
  const int k = rd.ntab == 4 ? 3 : 2;
  // this block's instance
  const int inst = blockIdx.y;
  const int64_t toff = inst * rd.inst_words;  // TAB(q): table q of this instance
#define TAB(q) (rd.tab[q] + toff)
  const int32_t* r_dev = rd.r_dev ? rd.r_dev + inst * rd.r_stride : nullptr;
  u64* scratch = scratch_all + inst * (SC_TICKET + 1);
  int32_t* evals = evals_all ? evals_all + inst * (k * OTTI_NL) : nullptr;

  // ---- load the block's segments into shared memory
  if (rd.bulk) {
    if (tid == 0) {
      mbar_init(&bar, 1);
      mbar_init_fence();
      mbar_expect(&bar, (uint32_t)(rd.ntab * nseg * SC_SEG_BYTES));
      for (int q = 0; q < rd.ntab; ++q)
        for (int sg = 0; sg < nseg; ++sg) {
          const int64_t row = i0 + (sg & 1 ? rd.h : 0) + (sg & 2 ? rd.ah : 0);
          bulk_load(raw[q][sg], TAB(q) + row * OTTI_NL, SC_SEG_BYTES, &bar);
        }
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    mbar_wait(&bar, 0);
  } else {
    for (int idx = tid; idx < rd.ntab * nseg * SC_SEG_WORDS; idx += SC_THREADS) {
      const int q = idx / (nseg * SC_SEG_WORDS), rem = idx % (nseg * SC_SEG_WORDS);
      const int sg = rem / SC_SEG_WORDS, w = rem % SC_SEG_WORDS;
      const int64_t i = i0 + w / OTTI_NL;
      if (i < (sg & 1 ? rd.npairs : rd.nlo)) {
        const int64_t row = i + (sg & 1 ? rd.h : 0) + (sg & 2 ? rd.ah : 0);
        raw[q][sg][w] = TAB(q)[row * OTTI_NL + w % OTTI_NL];
      }
    }
    __syncthreads();
  }

  // ---- stage 1: one thread per (table, element); bind, keep words, restage limbs
  {
    const int q = tid / (2 * SC_P), slot = tid % (2 * SC_P);
    const int sg = slot / SC_P, row = slot % SC_P;
    if (q < rd.ntab && i0 + row < (sg ? rd.npairs : rd.nlo)) {
      int32_t* mine = raw[q][sg] + row * OTTI_NL;
      Fe x = load_canon(mine);
      if (bind) {
        Fe r = rd.r;
        if (r_dev) {  // squeezed on the card: read where the transcript left it
          int32_t limbs[OTTI_NL];
#pragma unroll
          for (int l = 0; l < OTTI_NL; ++l) limbs[l] = r_dev[l];
          r = fe_canon<FIELD_SCALAR>(fe_pack(limbs));
        }
        const Fe y = load_canon(raw[q][sg + 2] + row * OTTI_NL);
        x = fe_add<FIELD_SCALAR>(
            x, fe_mul<FIELD_SCALAR>(r, fe_sub<FIELD_SCALAR>(y, x)));
        fe_store_row(mine, x);
      }
#pragma unroll
      for (int w = 0; w < OTTI_NW; ++w) bound[q][w][slot] = x.w[w];
    }
  }
  if (bind && rd.bulk) async_proxy_fence();
  __syncthreads();

  // ---- bound rows go back to the tables (under stage 2 when by bulk store)
  if (bind) {
    if (rd.bulk) {
      if (tid == 0) {
        for (int q = 0; q < rd.ntab; ++q)
          for (int sg = 0; sg < 2; ++sg)
            bulk_store(TAB(q) + (i0 + (sg ? rd.h : 0)) * OTTI_NL, raw[q][sg],
                       SC_SEG_BYTES);
        bulk_commit();
      }
    } else {
      for (int idx = tid; idx < rd.ntab * 2 * SC_SEG_WORDS; idx += SC_THREADS) {
        const int q = idx / (2 * SC_SEG_WORDS), rem = idx % (2 * SC_SEG_WORDS);
        const int sg = rem / SC_SEG_WORDS, w = rem % SC_SEG_WORDS;
        const int64_t i = i0 + w / OTTI_NL;
        if (i < (sg ? rd.npairs : rd.nlo))
          TAB(q)[(i + (sg ? rd.h : 0)) * OTTI_NL + w % OTTI_NL] = raw[q][sg][w];
      }
    }
  }
  if (rd.npairs == 0) return;  // bare final bind (never by bulk store)

  // ---- stage 2: one thread per (point, pair)
  if (tid < k * SC_P) {
    const int e = tid / SC_P, i = tid % SC_P;
    const int t = e == 0 ? 0 : e + 1;  // points 0, 2, 3
    Fe term;
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) term.w[w] = 0;
    if (i0 + i < rd.npairs) {
      if (rd.ntab == 4) {
        const Fe ab = fe_mul<FIELD_SCALAR>(ext_point(bound[1], i, t), ext_point(bound[2], i, t));
        const Fe w = fe_sub<FIELD_SCALAR>(ab, ext_point(bound[3], i, t));
        term = fe_mul<FIELD_SCALAR>(ext_point(bound[0], i, t), w);
      } else {
        term = fe_mul<FIELD_SCALAR>(ext_point(bound[0], i, t), ext_point(bound[1], i, t));
      }
    }
#pragma unroll
    for (int w = 0; w < OTTI_NW; ++w) terms[e][w][i] = term.w[w];
  }
  __syncthreads();

  // ---- exact word sums: block, then card; the last block finishes
  if (tid < k * OTTI_NW) {
    const uint32_t* col = terms[tid / OTTI_NW][tid % OTTI_NW];
    u64 s = 0;
#pragma unroll
    for (int i = 0; i < SC_P; ++i) s += col[i];
    atomicAdd(&scratch[tid], s);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&scratch[SC_TICKET], 1ull) == (u64)gridDim.x - 1;
  __syncthreads();
  if (is_last) {
    if (tid < k * OTTI_NW) sums[tid] = atomicExch(&scratch[tid], 0ull);
    if (tid == 0) scratch[SC_TICKET] = 0;
    __syncthreads();
    if (tid < k) {
      // each word sum < npairs * 2^32; the total < npairs * l < 2^284
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
  if (rd.bulk && bind && tid == 0) bulk_wait_all();
#undef TAB
}

static int32_t g_consts[sizeof(FieldConsts) * 2 / 4];  // FieldConsts[2], for every device
static PerDevice g_devices;

// Keeps the constants on the host; each device gets them at its first
// launch (DeviceScope).
extern "C" int otti_sumcheck_init(const int32_t* consts) {
  memcpy(g_consts, consts, sizeof(g_consts));
  return 0;
}

static int setup_device(int) { return set_field_consts(g_consts); }

// tables: ntab (2 or 4) pointers to batch instances' [n, 22] int32 device
// tables each ([batch, n, 22], contiguous), updated in place.  r: the 8 words
// of the canonical challenge in host memory, shared by the instances, or
// r_dev: the challenges as 22 int32 limbs in device memory (a value in
// [0, 2^256), |limb| < 2^18), instance b's at r_dev + b * r_stride (r_stride
// 0: one shared), read by the kernel; r_dev wins when both are given; both
// are ignored when ah == 0.  ah: the previous active half (0: no bind, 1:
// bare final bind, which evaluates nothing).  half: the pair distance when
// ah == 0.  scratch: 25 uint64 an instance on the device, zero before the
// first launch and left zero by every launch (24 accumulators and the
// ticket); launches that share it must be ordered on one stream.  evals:
// k * 22 int32 an instance (k = 3 cubic, 2 quad), unused when ah == 1.
// device: the tables' CUDA device, whose stream ``stream`` is.  Returns the
// launch's cudaGetLastError().
extern "C" int otti_sumcheck_round(int32_t* t0, int32_t* t1, int32_t* t2,
                                   int32_t* t3, int ntab, int batch, long long n,
                                   const uint32_t* r_host, const int32_t* r_dev, int r_stride,
                                   long long ah, long long half, u64* scratch,
                                   int32_t* evals, int device, void* stream) {
  if ((ntab != 2 && ntab != 4) || ah < 0 || batch < 1 || batch > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;
  Round rd;
  rd.tab[0] = t0;
  rd.tab[1] = t1;
  rd.tab[2] = t2;
  rd.tab[3] = t3;
  rd.inst_words = n * OTTI_NL;
  rd.ntab = ntab;
  for (int w = 0; w < OTTI_NW; ++w) rd.r.w[w] = ah > 0 && r_host ? r_host[w] : 0u;
  rd.r_dev = ah > 0 ? r_dev : nullptr;
  rd.r_stride = r_stride;
  rd.ah = ah;
  rd.h = ah > 0 ? ah / 2 : half;
  rd.npairs = rd.h;
  rd.nlo = ah == 1 ? 1 : rd.h;
  if (rd.nlo <= 0) return 0;
  uintptr_t bits = batch > 1 ? (uintptr_t)(rd.inst_words * 4) : 0;  // every instance aligned
  for (int q = 0; q < ntab; ++q) bits |= (uintptr_t)rd.tab[q];
  rd.bulk = (bits & 15) == 0 && rd.npairs > 0 && rd.npairs % SC_P == 0;
  const long long blocks = (rd.nlo + SC_P - 1) / SC_P;
  DeviceScope scope(device, g_devices, setup_device);
  if (scope.err) return scope.err;
  sumcheck_round_kernel<<<dim3((unsigned)blocks, (unsigned)batch), SC_THREADS, 0,
                          (cudaStream_t)stream>>>(rd, scratch, evals);
  return (int)cudaGetLastError();
}
