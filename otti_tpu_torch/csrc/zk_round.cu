// Kernel K6: one zero-knowledge sumcheck round after its evaluations, one
// block an instance (csrc/zk_round.cuh holds the round).
//
// Replaces no kernel of the JAX package: otti_tpu/spartan/zkfused.py leaves
// the round to XLA, whose fusion makes it a handful of programs.  The port
// ran it as a chain of torch operations (spartan/zkfused.py
// _zk_round_from_evals): three comb MSMs of a few hundred point additions,
// three encodings, about fourteen transcript operations and the sigma
// arithmetic, some 2,500 launches a round, each a few microseconds of the
// card's time for well under that of work.  Here it is one launch after
// kernel 2's.
//
// What bounds it on an H100: the latency of its dependent chains, not
// operations or bytes (a round reads about 20 KB of table entries and does
// some 3,000 field multiplies).  Three encodings follow one another (C_poly
// before r, comm_eval before w0 and w1, C_y before c), each K4's chain of
// about 285 dependent multiplies, and between them the transcript's
// Keccak-f permutations on one warp (K3's chain) and the comb sums (a tree
// of log2(64) + 2 or 3 point additions).  So: one block of 128 threads an
// instance; the two commitments of a group summed on the block's two halves
// and encoded on two lanes side by side; the delta and beta encodings ride
// beside C_poly's and C_y's; everything between the launches stays in
// shared memory.  The least time is about three K4 encodings plus the
// round's permutations at K3's floor.  To stay within 128 registers without
// spills (the encoding alone takes about 120), the encoding is a called
// function and an addition's products run two at a time on operands in
// shared memory: a round takes about 10 % longer than with the additions'
// products side by side in 150 registers.
//
// B instances of one shape (spartan/batched.py) are grid y; the degree, 2
// or 3, is a template parameter.
#include <string.h>

#include "device.cuh"
#include "zk_round.cuh"

#define ZR_INPUTS 8  // evs, e, be, b_poly, b_next, d, r_delta, r_beta

struct ZrArgs {
  const int32_t* in[ZR_INPUTS];
  long long stride[ZR_INPUTS];  // int32 elements from one instance's rows to the next's (0: shared)
  const int32_t* vinv;
  const int32_t* table;
  const uint8_t* prog;
  uint8_t* state;  // [B, 200]
  int32_t* e_next;  // [B, 22]
  int32_t* r;       // [B, 22]
  uint8_t* encs;    // [B, 4, 32]
  int32_t* z;       // [B, degree + 1, 22]
  int32_t* zdb;     // [B, 2, 22]
  int pos, pos_begin, cur_flags;
};

template <int D>
__global__ void __launch_bounds__(ZR_THREADS) zk_round_kernel(const ZrArgs a) {
  __shared__ ZrShared sh;
  __shared__ ZrIo io;  // in shared memory, so the pointers hold no registers through the round
  if (threadIdx.x == 0) {
    const long long b = blockIdx.y;
    const int32_t* in[ZR_INPUTS];
    for (int k = 0; k < ZR_INPUTS; ++k) in[k] = a.in[k] + b * a.stride[k];
    io.evs = in[0];
    io.e = in[1];
    io.be = in[2];
    io.b_poly = in[3];
    io.b_next = in[4];
    io.d = in[5];
    io.r_delta = in[6];
    io.r_beta = in[7];
    io.vinv = a.vinv;
    io.table = a.table;
    io.prog = a.prog;
    io.state = a.state + 200 * b;
    io.pos = a.pos;
    io.pos_begin = a.pos_begin;
    io.cur_flags = a.cur_flags;
    io.e_next = a.e_next + OTTI_NL * b;
    io.r = a.r + OTTI_NL * b;
    io.z = a.z + OTTI_NL * (D + 1) * b;
    io.zdb = a.zdb + OTTI_NL * 2 * b;
    io.encs = a.encs + 128 * b;
  }
  __syncthreads();
  zk_round<D>(ZrBlock{(int)threadIdx.x}, sh, io);
}

// FieldConsts[2], RistrettoConsts, then ZkConsts, for every device
static int32_t g_consts[(sizeof(FieldConsts) * 2 + sizeof(RistrettoConsts) + sizeof(ZkConsts)) /
                        4];
static PerDevice g_devices;

// consts: the FieldConsts[2] block, the 16 words of RistrettoConsts, the 8
// words of 2 d mod p (_build.zk_round_consts).  Kept on the host; each device
// gets them at its first launch (DeviceScope).
extern "C" int otti_zk_round_init(const int32_t* consts) {
  memcpy(g_consts, consts, sizeof(g_consts));
  return 0;
}

static int setup_device(int) {
  int err = set_field_consts(g_consts);
  if (err) return err;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(g_consts);
  err = set_ristretto_consts(words + sizeof(FieldConsts) * 2 / 4);
  if (err) return err;
  return set_zk_consts(words + (sizeof(FieldConsts) * 2 + sizeof(RistrettoConsts)) / 4);
}

// args (host memory, 27 values): the 8 input row pointers, their 8 batch
// strides, then vinv, table, prog, state, e_next, r, encs, z, zdb.  One
// block an instance for ``batch`` instances; pos, pos_begin, cur_flags: the
// STROBE offsets every instance's state is at.  Returns the launch's
// cudaGetLastError().
extern "C" int otti_zk_round(const long long* args, int degree, int batch, int pos,
                             int pos_begin, int cur_flags, int device, void* stream) {
  if (batch <= 0 || batch > 65535 || (degree != 2 && degree != 3))
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device, g_devices, setup_device);
  if (scope.err) return scope.err;
  ZrArgs a;
  for (int k = 0; k < ZR_INPUTS; ++k) {
    a.in[k] = reinterpret_cast<const int32_t*>(args[k]);
    a.stride[k] = args[ZR_INPUTS + k];
  }
  const long long* p = args + 2 * ZR_INPUTS;
  a.vinv = reinterpret_cast<const int32_t*>(p[0]);
  a.table = reinterpret_cast<const int32_t*>(p[1]);
  a.prog = reinterpret_cast<const uint8_t*>(p[2]);
  a.state = reinterpret_cast<uint8_t*>(p[3]);
  a.e_next = reinterpret_cast<int32_t*>(p[4]);
  a.r = reinterpret_cast<int32_t*>(p[5]);
  a.encs = reinterpret_cast<uint8_t*>(p[6]);
  a.z = reinterpret_cast<int32_t*>(p[7]);
  a.zdb = reinterpret_cast<int32_t*>(p[8]);
  a.pos = pos;
  a.pos_begin = pos_begin;
  a.cur_flags = cur_flags;
  const dim3 grid(1, (unsigned)batch);
  if (degree == 2)
    zk_round_kernel<2><<<grid, ZR_THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    zk_round_kernel<3><<<grid, ZR_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
