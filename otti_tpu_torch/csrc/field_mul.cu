// Kernel 1: batched field multiply, out[i] = a[i] * b[i] mod m (canonical),
// over rows of 22 int32 limbs; b may be one row shared by all.
//
// Replaces otti_tpu/field/pallas_kernels.py::_mul_kernel_factory (entered
// through _mul_call / mul_pallas), and with the shared second operand the
// int8-MXU shared-scalar multiply ops.mul_scalar.  The function is the same;
// the recipe is this card's, not the TPU's (which convolved 12-bit limbs on
// an int32 vector unit and reduced through a 23 x 22 fold matrix).
//
// What bounds it on an H100: bytes.  A product moves 264 B (two 88 B rows
// in, one out) against about 124 (SCALAR) or 73 (BASE) 32x32->64 multiplies
// and a few hundred adds and shifts, so the card's memory rate, not its
// integer rate, sets the least time.  The design is built around that:
//
//   * Arithmetic on machine words (field.cuh): a thread packs its two rows
//     into 8 words each, multiplies them in carry chains, reduces by the
//     shape of the modulus and unpacks the canonical result.
//   * A tile is 128 consecutive rows, 11,264 contiguous bytes of each
//     operand.  One thread asks the copy engine for them (cp.async.bulk,
//     completion on an mbarrier); the threads then read their own rows from
//     shared memory with 8-byte loads (row stride 88 B: conflict-free for
//     8-byte accesses), write the result over their own row of a, and one
//     bulk store sends the tile back.  Global memory sees only full-width
//     contiguous transfers.
//   * A few blocks per SM walk over the tiles with two buffers: the copy of
//     a block's next tile runs under the arithmetic of this one.
//   * A ragged last tile (n not a multiple of 128), and every tile when a
//     pointer is not 16-byte aligned, is loaded and stored by all threads
//     with plain coalesced 4-byte accesses, masked by row.
//   * The tensor cores have no part: these are exact 255-bit integers.
#include "async_copy.cuh"
#include "field.cuh"

#define FM_ROWS 128
#define FM_TILE_WORDS (FM_ROWS * OTTI_NL)
#define FM_TILE_BYTES (FM_TILE_WORDS * 4)

template <int F>
__global__ void __launch_bounds__(FM_ROWS)
field_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int64_t n, int b_shared, int bulk) {
  __shared__ __align__(128) int32_t sa[2][FM_TILE_WORDS];
  __shared__ __align__(128) int32_t sb[2][FM_TILE_WORDS];
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  const int64_t nfull = n / FM_ROWS;  // tiles that hold all 128 rows
  const int64_t ntiles = (n + FM_ROWS - 1) / FM_ROWS;
  const uint32_t tile_tx = b_shared ? FM_TILE_BYTES : 2 * FM_TILE_BYTES;

  Fe shared_b;
  if (b_shared) {  // 22 words every thread reads once, from the cache
    int32_t x[OTTI_NL];
#pragma unroll
    for (int i = 0; i < OTTI_NL; ++i) x[i] = b[i];
    shared_b = fe_pack(x);
  }
  if (bulk) {
    if (tid == 0) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
  // thread 0 only: ask for tile `tile` of a (and b) into buffer s
  auto request = [&](int64_t tile, int s) {
    mbar_expect(&bar[s], tile_tx);
    bulk_load(sa[s], a + tile * FM_TILE_WORDS, FM_TILE_BYTES, &bar[s]);
    if (!b_shared) bulk_load(sb[s], b + tile * FM_TILE_WORDS, FM_TILE_BYTES, &bar[s]);
  };

  int64_t tile = blockIdx.x;
  if (bulk && tid == 0 && tile < nfull) request(tile, 0);
  for (int k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int s = k & 1;
    const bool whole = bulk && tile < nfull;
    const int64_t row0 = tile * FM_ROWS;
    const int rows = (int)(n - row0 < FM_ROWS ? n - row0 : FM_ROWS);
    if (bulk && tid == 0) {
      // The other buffer was stored from at the end of the last iteration:
      // that store must have read it before the next copy lands there.
      // (Every thread is past that iteration's barrier, so none reads it.)
      bulk_wait_read();
      if (tile + gridDim.x < nfull) request(tile + gridDim.x, s ^ 1);
    }
    if (whole) {
      mbar_wait(&bar[s], (uint32_t)(k >> 1) & 1u);
    } else {
      for (int i = tid; i < rows * OTTI_NL; i += FM_ROWS) {
        sa[s][i] = a[row0 * OTTI_NL + i];
        if (!b_shared) sb[s][i] = b[row0 * OTTI_NL + i];
      }
      __syncthreads();
    }
    if (tid < rows) {
      const Fe x = fe_load_row(sa[s] + tid * OTTI_NL);
      const Fe y = b_shared ? shared_b : fe_load_row(sb[s] + tid * OTTI_NL);
      fe_store_row(sa[s] + tid * OTTI_NL, fe_mul<F>(x, y));  // over this thread's own row
    }
    if (whole) {
      async_proxy_fence();
      __syncthreads();
      if (tid == 0) {
        bulk_store(out + row0 * OTTI_NL, sa[s], FM_TILE_BYTES);
        bulk_commit();
      }
    } else {
      __syncthreads();
      for (int i = tid; i < rows * OTTI_NL; i += FM_ROWS) out[row0 * OTTI_NL + i] = sa[s][i];
    }
  }
  if (bulk && tid == 0) bulk_wait_all();
}

static int g_max_blocks[2] = {0, 0};  // resident blocks on the whole card, by field

extern "C" int otti_field_mul_init(const int32_t* consts) {
  int err = set_field_consts(consts);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, field_mul_kernel<FIELD_SCALAR>, FM_ROWS, 0)))
    return err;
  g_max_blocks[FIELD_SCALAR] = sms * (per_sm > 0 ? per_sm : 1);
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, field_mul_kernel<FIELD_BASE>, FM_ROWS, 0)))
    return err;
  g_max_blocks[FIELD_BASE] = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// a, out: [n, 22] int32 on the device; b: [n, 22], or one [22] element shared
// by all rows when b_broadcast != 0.  field: FIELD_SCALAR or FIELD_BASE.
// Returns the launch's cudaGetLastError().
extern "C" int otti_field_mul(const int32_t* a, const int32_t* b, int32_t* out,
                              long long n, int b_broadcast, int field,
                              void* stream) {
  if (n <= 0) return 0;
  if (field != FIELD_SCALAR && field != FIELD_BASE) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + FM_ROWS - 1) / FM_ROWS;
  const long long cap = g_max_blocks[field] > 0 ? g_max_blocks[field] : 1;
  const unsigned blocks = (unsigned)(ntiles < cap ? ntiles : cap);
  uintptr_t bits = (uintptr_t)a | (uintptr_t)out;
  if (!b_broadcast) bits |= (uintptr_t)b;
  const int bulk = (bits & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == FIELD_SCALAR)
    field_mul_kernel<FIELD_SCALAR><<<blocks, FM_ROWS, 0, s>>>(a, b, out, n, b_broadcast, bulk);
  else
    field_mul_kernel<FIELD_BASE><<<blocks, FM_ROWS, 0, s>>>(a, b, out, n, b_broadcast, bulk);
  return (int)cudaGetLastError();
}
