// Kernel K4: ristretto255 encoding of a batch of extended Edwards points.
//
// Replaces otti_tpu/curve/ristretto.py::encode (with sqrt_ratio_m1), which
// the JAX package leaves to XLA as a chain of batched field operations.  In
// the port's plain torch that chain is some 270 launches of the multiply
// kernel and a few hundred more for the adds, selects and canonicalisations
// (an inverse square root alone is 251 squarings), once for every
// commitment the device transcript absorbs: three calls a zero-knowledge
// sumcheck round.  Here it is one launch.
//
// What bounds it on an H100: operations.  A point costs about 285 BASE
// multiplies against 4 x 88 B read and 32 B written, so at the card's
// integer rate the arithmetic, not the memory, sets the least time.  At the
// transcript's sizes (1, 2 or 11 points; a witness commitment's 2^k rows)
// that least time is far below a microsecond, and what a launch takes is the
// latency of the chain: 285 dependent multiplies in one thread, 251 of them
// squarings.  The design shortens that chain (ristretto.cuh):
//
//   * A dedicated square, 36 word products instead of 64, for every squaring.
//   * Loose multiplies inside the chain: fold 2^256 = 38, return any value
//     below 2^256, and canonicalise only where a value is compared, its sign
//     read, added or subtracted, or written out (eight points in all).
//   * On the device the products are summed column by column (product
//     scanning) with PTX carry instructions, mad.lo.cc / madc.hi.cc / addc
//     into a three-word accumulator, so a product is three dependent
//     instructions and no row of partial words is carried through.
//   * One thread a point, everything in registers, 32 threads a block: a
//     batch of 4,096 points spreads over 128 SMs, one warp each, where 128
//     threads a block put it on 32 SMs, a warp on each of their four
//     schedulers.  Each warp is one dependent chain either way, so the
//     spread only keeps the warps from sharing an SM's caches.
//   * About 120 registers a thread, no spills and no local memory: every
//     loop over words has a fixed trip count, so each product's words stay
//     in registers.  (A cap of 128 registers by the launch bound made
//     ptxas spill.)
//   * One warp a point, the product's columns spread over lanes and summed
//     with shuffles, was not built: at n <= 11 a shuffle's latency sits on
//     the same dependent chain as the carry it replaces.
//   * It reads the port's semi-reduced limbs as the multiply kernel and the
//     torch ops leave them (any row in [0, 2^256) with |limb| < 2^18).
#include <string.h>

#include "device.cuh"
#include "ristretto.cuh"

#define RE_THREADS 32

__global__ void __launch_bounds__(RE_THREADS)
ristretto_encode_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                        const int32_t* __restrict__ z, const int32_t* __restrict__ t,
                        uint8_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * RE_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t off = i * OTTI_NL;
  uint8_t enc[32];
  ristretto_encode_fe(fe_load_row(x + off), fe_load_row(y + off), fe_load_row(z + off),
                      fe_load_row(t + off), enc);
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + i * 32);
#pragma unroll
  for (int w = 0; w < 8; ++w)
    dst[w] = (uint32_t)enc[4 * w] | ((uint32_t)enc[4 * w + 1] << 8) |
             ((uint32_t)enc[4 * w + 2] << 16) | ((uint32_t)enc[4 * w + 3] << 24);
}

// FieldConsts[2] then RistrettoConsts, for every device
static int32_t g_consts[(sizeof(FieldConsts) * 2 + sizeof(RistrettoConsts)) / 4];
static PerDevice g_devices;

// consts: the FieldConsts[2] block (as every kernel library takes it), then
// the 16 words of RistrettoConsts.  Kept on the host; each device gets them
// at its first launch (DeviceScope).
extern "C" int otti_ristretto_init(const int32_t* consts) {
  memcpy(g_consts, consts, sizeof(g_consts));
  return 0;
}

static int setup_device(int) {
  const int err = set_field_consts(g_consts);
  if (err) return err;
  return set_ristretto_consts(reinterpret_cast<const uint32_t*>(g_consts) +
                              sizeof(FieldConsts) * 2 / 4);
}

// x, y, z, t: [n, 22] int32 limb rows on the device (8-byte aligned rows);
// out: n x 32 bytes (4-byte aligned); device: their CUDA device, whose stream
// ``stream`` is.  Returns the launch's cudaGetLastError().
extern "C" int otti_ristretto_encode(const int32_t* x, const int32_t* y, const int32_t* z,
                                     const int32_t* t, uint8_t* out, long long n, int device,
                                     void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  DeviceScope scope(device, g_devices, setup_device);
  if (scope.err) return scope.err;
  const long long blocks = (n + RE_THREADS - 1) / RE_THREADS;
  ristretto_encode_kernel<<<(unsigned)blocks, RE_THREADS, 0, (cudaStream_t)stream>>>(
      x, y, z, t, out, n);
  return (int)cudaGetLastError();
}
