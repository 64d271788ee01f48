// The flip / p-flip sweep for Hopper (sm_90a): a warp scans a lane, 32 bits at a time.
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
// within a lane, so a lane's time is the latency of its chain of steps, not
// bytes or operations. With one thread a lane the chain is n steps a sweep,
// each a dependent load of the bit's checks, a shared-memory read and a
// compare, and a warp runs until the slowest of its 32 lanes has finished
// its last sweep.
//
// What the design does about it:
//   - One warp works on one lane and scans 32 bits of the sweep at a time
//     against the current syndrome: each thread decides its own bit, a
//     ballot finds the first bit that flips, its thread applies that flip
//     (syndrome, decoding, weight, convergence test), and the scan resumes
//     at the next bit. A bit's decision depends only on the flips before it,
//     so the order of flips, the mid-sweep convergence, the reported sweep
//     and the fixpoint stop are those of the one-bit-at-a-time sweep
//     (ops/flip.py::flip_scan_reference is the plain model of the scan). A
//     sweep is about n / 32 scans plus one a flip instead of n steps.
//     Measured on the H100 at the d=13 main-path call against 1 and 8
//     threads a lane in the same kernel, a warp a lane was 5.7x and 1.4x
//     faster, on toric d=20 35x and 2.1x, with p-flip on 12x and 2.5x.
//   - var_chks (n * dv ints, the same for every lane) is staged in shared
//     memory once a block, transposed to (dv, n) so a scan's reads fall on
//     distinct banks, and no load from device memory is left on a scan's
//     path.
//   - A lane's syndrome is loaded coalesced and packed by __ballot_sync into
//     shared-memory words; the decoding is kept as bits in shared memory and
//     written once, coalesced, zeros included, so the wrapper zero-fills
//     nothing and a flip touches no device memory.
//   - No block barrier after the staging: a lane's threads are one warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, so 8 lanes, a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct FlipArgs {
  const uint8_t* synd;   // (B, m)
  const int* var_chks;   // (n, dv), pad = m
  int m, n, dv, B, max_iter, pfreq;
  uint32_t seed;
  uint8_t* dec;          // (B, n)
  bool* conv;            // (B,)
  int* iters;            // (B,)
};

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

// Words of shared memory a lane takes: its syndrome, then the bits of its
// decoding.
__host__ __device__ inline int lane_words(int m, int n) {
  return ((m + 31) >> 5) + ((n + 31) >> 5);
}

__global__ void __launch_bounds__(kThreads) flip_kernel(const FlipArgs a) {
  extern __shared__ uint32_t smem[];
  const int m = a.m, n = a.n, dv = a.dv;
  const int Wm = (m + 31) >> 5;
  const int Wx = (n + 31) >> 5;
  const int t = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  int* s_vc = reinterpret_cast<int*>(smem);  // (dv, n): check k of bit j
  for (int i = threadIdx.x; i < n * dv; i += kThreads) {
    const int j = i / dv;
    s_vc[(i - j * dv) * n + j] = __ldg(a.var_chks + i);
  }
  __syncthreads();
  const int lane = blockIdx.x * kWarps + wib;
  if (lane >= a.B) return;  // whole warps only; no block barrier follows
  uint32_t* s_syn = smem + n * dv + (size_t)wib * lane_words(m, n);  // (Wm,) the syndrome
  uint32_t* s_dec = s_syn + Wm;                                  // (Wx,) the decoding

  // the lane's syndrome, 32 bytes a load, packed by ballot
  const uint8_t* s_lane = a.synd + (size_t)lane * m;
  int weight = 0;
#pragma unroll 4
  for (int w = 0; w < Wm; ++w) {
    const int r = w * 32 + t;
    const uint32_t word = __ballot_sync(kFull, r < m && s_lane[r] != 0);
    if (t == 0) s_syn[w] = word;
    weight += __popc(word);
  }
  for (int w = t; w < Wx; w += 32) s_dec[w] = 0;
  __syncwarp();

  bool conv = weight == 0;
  int iters = 0;
  int it = 0;
  while (!conv && it < a.max_iter) {
    ++it;
    const bool pflip = a.pfreq > 0 && it % a.pfreq == 0;
    bool flipped = false;
    for (int j0 = 0; j0 < n;) {
      // every thread decides its own bit against the current syndrome
      const int j = j0 + t;
      int gain = 0;  // satisfied minus unsatisfied checks: a flip's change of weight
      bool flip = false;
      if (j < n) {
        int deg = 0, unsat = 0;
        for (int k = 0; k < dv; ++k) {
          const int c = s_vc[k * n + j];
          if (c < m) {
            ++deg;
            unsat += (s_syn[c >> 5] >> (c & 31)) & 1u;
          }
        }
        gain = deg - 2 * unsat;
        flip = gain < 0;
        if (!flip && pflip && gain == 0) {
          flip = coin(a.seed, (uint32_t)lane, (uint32_t)it, (uint32_t)j);
        }
      }
      const unsigned vote = __ballot_sync(kFull, flip);
      if (!vote) {
        j0 += 32;
        continue;
      }
      // the first bit that flips: the bits before it stay, the bits after
      // it are decided again
      const int first = __ffs(vote) - 1;
      if (t == first) {
        s_dec[j >> 5] ^= 1u << (j & 31);
        for (int k = 0; k < dv; ++k) {
          const int c = s_vc[k * n + j];
          if (c < m) s_syn[c >> 5] ^= 1u << (c & 31);
        }
      }
      weight += __shfl_sync(kFull, gain, first);
      __syncwarp();
      flipped = true;
      if (weight == 0) {
        conv = true;
        iters = it;
        break;
      }
      j0 += first + 1;
    }
    if (!flipped && a.pfreq == 0) break;  // a fixpoint
  }

  uint8_t* out = a.dec + (size_t)lane * n;
  for (int j = t; j < n; j += 32) out[j] = (uint8_t)((s_dec[j >> 5] >> (j & 31)) & 1u);
  if (t == 0) {
    a.conv[lane] = conv;
    a.iters[lane] = conv ? iters : a.max_iter;
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes for an (m, n) code of bit degree dv;
// the caller checks it against the card's 227 KB.
int ldpc_flip_smem(int m, int n, int dv) {
  return (int)(((size_t)n * dv + (size_t)kWarps * lane_words(m, n)) * sizeof(uint32_t));
}

// Returns cudaGetLastError() after the launch (0 on success), or the error
// of raising the block's shared-memory limit.
int ldpc_flip(const void* synd, const void* var_chks, int m, int n, int dv,
              int B, int max_iter, int pfreq, unsigned int seed, void* dec,
              void* conv, void* iters, void* stream) {
  const size_t smem = (size_t)ldpc_flip_smem(m, n, dv);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // cleared: not the next launch's error
      return (int)err;
    }
  }
  FlipArgs a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.var_chks = static_cast<const int*>(var_chks);
  a.m = m;
  a.n = n;
  a.dv = dv;
  a.B = B;
  a.max_iter = max_iter;
  a.pfreq = pfreq;
  a.seed = (uint32_t)seed;
  a.dec = static_cast<uint8_t*>(dec);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  flip_kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
