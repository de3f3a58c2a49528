// Kernel K3: Keccak-f[1600] on a batch of 200-byte states, in place, with
// STROBE's pad XORed in first when asked.
//
// Replaces otti_tpu/transcript/device.py::keccak_f1600_lanes (entered
// through keccak_f1600_bytes), which the JAX package leaves to XLA: 24
// rounds of theta, rho, pi, chi and iota on 25 64-bit lanes, held there as
// uint32 (lo, hi) halves.  The pad is the XOR that device.py's
// DeviceStrobe._run_f applies before each permutation.
//
// What bounds it on an H100: at one state (the device transcript's case:
// one permutation each time the 166-byte rate fills or an operation forces
// it) nothing but the launch and the rounds' dependent latency; the work is
// about 10,000 32-bit operations.  For a batch, operations: 400 B a state
// (read once, written once) against those 10,000 operations.  The design
// (keccak.cuh):
//
//   * One warp a state, thread t < 25 holding lane t in registers; a round
//     is four shuffle exchanges (theta's column and its neighbours, rho+pi's
//     gather, chi's row), each followed by a few LOP3 and funnel-shift
//     operations.  No shared memory, no __syncwarp.
//   * Why not one thread a state, the 25 lanes in registers and pi a
//     renaming: it issues some 5,000 integer instructions from one thread,
//     and at half a warp instruction a cycle that alone takes longer than
//     the launch.  chip_smoke.py's device_fs phase times that design beside
//     this kernel (PERF.md has the numbers): slower at one state, the
//     transcript's case, slightly faster at 4,096 states.
//   * A lane is read and written as one 8-byte word, in place.
//   * The pad is XORed into the lanes in the same launch, so the
//     transcript's permutation is one launch, not an XOR op and a launch.
//   * 128 threads a block, a state a warp.
#include <cuda_runtime.h>

#include "device.cuh"
#include "keccak.cuh"

#define K3_THREADS 128

__global__ void __launch_bounds__(K3_THREADS)
keccak_kernel(uint64_t* __restrict__ st, int64_t n, int pos, int pos_begin) {
  const int64_t s = ((int64_t)blockIdx.x * K3_THREADS + threadIdx.x) >> 5;
  if (s >= n) return;  // the whole warp: one state a warp
  const int lane = threadIdx.x & 31, t = lane < KECCAK_LANES ? lane : 0;
  uint64_t* p = st + s * KECCAK_LANES;
  KeccakWarp w;
  w.src = keccak_sources(t);
  w.t = t;
  const uint64_t a = keccak_rounds(w, p[t] ^ strobe_pad_lane(t, pos, pos_begin));
  if (lane < KECCAK_LANES) p[t] = a;
}

// states: n uint8 states of 200 bytes on the device (8-byte aligned),
// permuted in place; pos in [0, 166] applies the pad with pos_begin first,
// pos = -1 permutes only; device: their CUDA device, whose stream ``stream``
// is.  Returns the launch's cudaGetLastError().
extern "C" int otti_keccak_pad_f1600(uint8_t* states, long long n, int pos, int pos_begin,
                                     int device, void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (pos < -1 || pos > STROBE_RATE || ((uintptr_t)states & 7)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + K3_THREADS / 32 - 1) / (K3_THREADS / 32);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err) return scope.err;
  keccak_kernel<<<(unsigned)blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<uint64_t*>(states), n, pos, pos_begin);
  return (int)cudaGetLastError();
}
