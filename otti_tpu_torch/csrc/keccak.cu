// Kernel K3: Keccak-f[1600] on a batch of 200-byte states, in place.
//
// Replaces otti_tpu/transcript/device.py::keccak_f1600_lanes (entered
// through keccak_f1600_bytes), which the JAX package leaves to XLA: 24
// rounds of theta, rho, pi, chi and iota on 25 64-bit lanes, held there as
// uint32 (lo, hi) halves.  Here a lane is one uint64_t.
//
// What bounds it on an H100: at one state (the device transcript's case:
// one permutation each time the 166-byte rate fills or an operation forces
// it) nothing but the launch; 24 dependent rounds of a few dozen integer
// operations take a few microseconds.  For a batch, bytes: 400 B a state
// (read once, written once) against about 24 x 25 x 10 integer operations,
// so at B = 4,096 states the memory rate sets the least time (1.6 MB, about
// half a microsecond), and the rounds' dependent latency the real time.
// The design is the simplest that is right, and the layout the batch wants:
//
//   * One block of 32 threads (one warp) a state.  Thread t < 25 owns lane
//     t (x = t % 5, y = t / 5, the byte order of the state); the lanes live
//     in shared memory, and __syncwarp orders the steps of a round.
//   * theta: five threads form the column parities C[x], then every lane
//     XORs C[x - 1] ^ rotl(C[x + 1], 1).  rho and pi: lane t takes lane
//     PI_SRC[t] rotated by PI_ROT[t] (a gather into a second array).  chi
//     and iota: lane t from its row of that array.
//   * The state is read and written as 8 bytes a lane, in place.
//
// The round constants and the rho/pi tables come from the Python package
// (otti_tpu_torch/transcript/keccak.py::_RC and transcript/device.py's
// PI_SRC, PI_ROT), copied into constant memory by otti_keccak_init.
#include <cuda_runtime.h>
#include <stdint.h>

struct KeccakConsts {
  uint64_t rc[24];
  int32_t src[25];
  int32_t rot[25];
};

static __constant__ KeccakConsts KC;

__device__ __forceinline__ uint64_t rotl64(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

__global__ void __launch_bounds__(32) keccak_kernel(uint8_t* __restrict__ st) {
  __shared__ uint64_t A[25], B[25], C[5];
  const int t = threadIdx.x;
  uint8_t* s = st + (int64_t)blockIdx.x * 200;
  if (t < 25) {
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= (uint64_t)s[8 * t + k] << (8 * k);
    A[t] = v;
  }
  __syncwarp();
  const int x = t % 5, row = t - x;
  for (int r = 0; r < 24; ++r) {
    if (t < 5) C[t] = A[t] ^ A[t + 5] ^ A[t + 10] ^ A[t + 15] ^ A[t + 20];
    __syncwarp();
    if (t < 25) A[t] ^= C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
    __syncwarp();
    if (t < 25) B[t] = rotl64(A[KC.src[t]], KC.rot[t]);
    __syncwarp();
    if (t < 25) {
      uint64_t v = B[t] ^ (~B[row + (x + 1) % 5] & B[row + (x + 2) % 5]);
      if (t == 0) v ^= KC.rc[r];
      A[t] = v;
    }
    __syncwarp();
  }
  if (t < 25) {
    const uint64_t v = A[t];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[8 * t + k] = (uint8_t)(v >> (8 * k));
  }
}

// consts: KeccakConsts as the Python package lays it out (24 uint64 round
// constants, then 25 int32 sources and 25 int32 rotations).
extern "C" int otti_keccak_init(const void* consts) {
  return (int)cudaMemcpyToSymbol(KC, consts, sizeof(KeccakConsts));
}

// states: n uint8 states of 200 bytes on the device, permuted in place.
// Returns the launch's cudaGetLastError().
extern "C" int otti_keccak_f1600(uint8_t* states, long long n, void* stream) {
  if (n <= 0) return n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (n > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  keccak_kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>(states);
  return (int)cudaGetLastError();
}
