// The flip / p-flip sweep for Hopper (sm_90a): one thread per lane.
//
// Replaces the JAX package's flip engine, ldpc_tpu/ops/flip.py:22
// (make_flip_decoder): a fori_loop over the bits inside a while_loop over
// sweeps, vmapped over the batch, compiled by XLA as one program. It is not
// a Pallas kernel; in PyTorch the same loop would be n * max_iter
// sequential steps of several launches each, so the sweep is written here
// by hand. Its plain PyTorch version is ldpc_tpu_torch/ops/flip.py::
// flip_reference, which takes the same steps in the same order:
//   - bits in index order; a bit flips when its unsatisfied checks
//     outnumber its satisfied ones, or, on every pfreq-th sweep, on a tie
//     when the lane's coin for (seed, lane, sweep, bit) comes up;
//   - a flip updates the syndrome and its weight at once; the lane
//     converges when the weight reaches 0, tested after every bit, and
//     reports that sweep; a lane that never converges reports max_iter;
//   - with pfreq == 0 a sweep that flips nothing is a fixpoint (every later
//     sweep would flip nothing too), so the lane stops there.
// The coin is the top bit of a counter-based hash (lowbias32 applied four
// times), the same function as ops/flip.py::coin.
//
// What bounds it on the H100: the sweep is sequential and data-dependent
// within a lane, so a lane's time is the latency of its chain of n steps
// per sweep (a few dependent shared-memory reads and a compare each), not
// bytes or operations. Lanes are independent.
//
// What the design does about it: one thread per lane, so a warp runs 32
// lanes' sweeps side by side and many warps per SM hide each other's
// latency; a lane's syndrome lives in shared memory as packed 32-bit words,
// laid out word-major ([word][thread]) so a warp's reads of one word fall on
// 32 distinct banks. The check lists of a bit (var_chks, pad = m) are the
// same for every thread of the warp at the same step and come through the
// read-only cache as broadcasts. The decoding is zeroed by the wrapper and
// toggled in device memory on a flip, which is rare. There is no barrier:
// a block's threads never share data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // lanes per block; ops/flip.py::_THREADS

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool coin(uint32_t seed, uint32_t lane,
                                     uint32_t sweep, uint32_t bit) {
  return (mix32(mix32(mix32(mix32(seed) ^ lane) ^ sweep) ^ bit) >> 31) != 0;
}

__global__ void __launch_bounds__(kThreads)
    flip_kernel(const uint8_t* __restrict__ synd,    // (B, m)
                const int* __restrict__ var_chks,    // (n, dv), pad = m
                int m, int n, int dv, int B, int max_iter, int pfreq,
                uint32_t seed,
                uint8_t* __restrict__ dec,           // (B, n), zeroed
                bool* __restrict__ conv_out,         // (B,)
                int* __restrict__ iters_out) {       // (B,)
  extern __shared__ uint32_t s_words[];  // (Wm, kThreads)
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kThreads + tid;
  if (lane >= B) return;  // no barrier below: an idle thread may leave
  uint32_t* sw = s_words + tid;  // word w of this lane at sw[w * kThreads]
  const int Wm = (m + 31) >> 5;
  const uint8_t* s_lane = synd + (size_t)lane * m;
  int weight = 0;
  for (int w = 0; w < Wm; ++w) {
    uint32_t word = 0;
    for (int b = 0; b < 32 && w * 32 + b < m; ++b) {
      if (s_lane[w * 32 + b]) {
        word |= 1u << b;
        ++weight;
      }
    }
    sw[w * kThreads] = word;
  }
  uint8_t* d_lane = dec + (size_t)lane * n;
  bool conv = weight == 0;
  int iters = 0;
  int it = 0;
  while (!conv && it < max_iter) {
    ++it;
    const bool pflip = pfreq > 0 && it % pfreq == 0;
    bool flipped = false;
    for (int j = 0; j < n && !conv; ++j) {
      const int* vc = var_chks + (size_t)j * dv;
      int deg = 0, unsat = 0;
      for (int k = 0; k < dv; ++k) {
        const int c = __ldg(vc + k);
        if (c < m) {
          ++deg;
          unsat += (sw[(c >> 5) * kThreads] >> (c & 31)) & 1u;
        }
      }
      const int sat = deg - unsat;
      bool flip = unsat > sat;
      if (!flip && pflip && sat == unsat) {
        flip = coin(seed, (uint32_t)lane, (uint32_t)it, (uint32_t)j);
      }
      if (flip) {
        d_lane[j] ^= 1;
        for (int k = 0; k < dv; ++k) {
          const int c = __ldg(vc + k);
          if (c < m) sw[(c >> 5) * kThreads] ^= 1u << (c & 31);
        }
        weight += sat - unsat;
        flipped = true;
        if (weight == 0) {
          conv = true;
          iters = it;
        }
      }
    }
    if (!flipped && pfreq == 0) break;  // a fixpoint
  }
  conv_out[lane] = conv;
  iters_out[lane] = conv ? iters : max_iter;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// zeroes dec and checks that the shared memory, ceil(m / 32) * 64 * 4
// bytes, fits the card's 227 KB.
int ldpc_flip(const void* synd, const void* var_chks, int m, int n, int dv,
              int B, int max_iter, int pfreq, unsigned int seed, void* dec,
              void* conv, void* iters, void* stream) {
  const size_t smem = (size_t)((m + 31) / 32) * kThreads * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  flip_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(synd), static_cast<const int*>(var_chks), m,
      n, dv, B, max_iter, pfreq, (uint32_t)seed, static_cast<uint8_t*>(dec),
      static_cast<bool*>(conv), static_cast<int*>(iters));
  return (int)cudaGetLastError();
}

}  // extern "C"
