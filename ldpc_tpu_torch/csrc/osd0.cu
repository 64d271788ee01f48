// K2': batched OSD-0 (GF(2) Gauss-Jordan elimination) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ldpc_tpu/ops/gf2_pallas.py::_osd0_kernel
// (built by make_osd0_solver). For every lane it solves H x = s with the
// columns taken in the lane's reliability order, exactly as
// ldpc_tpu/ops/gf2.py::batched_rref(fast_exit=True, with_transform=False)
// and the plain PyTorch version
// ldpc_tpu_torch/ops/gf2_cuda.py::osd0_reference do:
//   the working matrix is [H | s], bit-packed 32 columns per word;
//   for each column in order, the pivot is the lowest-index unused row that
//   holds a 1 there; it is XORed into every other row holding a 1 (swap-free
//   Gauss-Jordan) and the row remembers its pivot column;
//   a lane stops once no unused row holds a syndrome 1, or once it has found
//   rank pivots (the rank of H is computed once on the host);
//   x0[col_of_row[r]] = syndrome bit of row r for every used row, and the
//   lane is valid when no unused row holds a syndrome 1.
//
// What bounds it on the H100: the sequential column loop. Each step is a
// test, a block-wide min, then m*Wp word XORs; the work per step is small,
// so a lane is bound by the latency of the step's two barriers rather than
// by bytes or operations. Device memory is touched only to load H and the
// syndrome once and to write x0 once.
//
// What the design does about it: one block per lane, with the lane's
// working matrix in shared memory (m rows of Wp = ceil((n+1)/32) words:
// 6.2 KB at d=13, 41.6 KB for the toric d=20 code; above 48 KB the launcher
// opts in to up to 227 KB). Threads own rows, so the column test and the
// XOR need no communication; the pivot is one shared-memory atomicMin, and
// the fast-exit test rides the step's closing __syncthreads_or. Many lanes
// run concurrently on each SM to hide the barrier latency. Shared memory,
// not a VMEM budget, sets the size limit, so there is no cliff near n=800.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void osd0_kernel(const uint8_t* __restrict__ synd,  // (B, m)
                            const int* __restrict__ order,     // (B, n)
                            const uint32_t* __restrict__ H,    // (m, Wp)
                            int m, int n, int Wp, int rank,
                            uint8_t* __restrict__ x0,          // (B, n)
                            bool* __restrict__ valid) {        // (B,)
  extern __shared__ uint32_t smem[];
  uint32_t* M = smem;                                   // (m, Wp)
  int* col_of_row = reinterpret_cast<int*>(M + (size_t)m * Wp);  // (m,)
  __shared__ int s_piv[2];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ws = n >> 5;                    // word of the syndrome column
  const uint32_t bs = (uint32_t)(n & 31);   // its bit
  const uint8_t* s_lane = synd + (size_t)lane * m;
  const int* ord = order + (size_t)lane * n;

  for (int idx = tid; idx < m * Wp; idx += nt) M[idx] = __ldg(H + idx);
  if (tid == 0) {
    s_piv[0] = m;
    s_piv[1] = m;
  }
  __syncthreads();
  // thread tid owns rows tid, tid + nt, ...; bit q of `used` is row tid + q*nt
  uint32_t used = 0;
  int unres = 0;
  for (int q = 0, r = tid; r < m; ++q, r += nt) {
    const uint32_t sb = s_lane[r] ? 1u : 0u;
    M[r * Wp + ws] |= sb << bs;
    unres |= (int)sb;
  }
  bool active = __syncthreads_or(unres) && rank > 0;

  int used_cnt = 0;
  for (int j = 0; j < n && active; ++j) {
    const int c = __ldg(ord + j);
    const int w = c >> 5;
    const uint32_t bit = (uint32_t)(c & 31);
    const int buf = j & 1;
    uint32_t colmask = 0;
    bool offered = false;
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      if ((M[r * Wp + w] >> bit) & 1u) {
        colmask |= 1u << q;
        if (!offered && !((used >> q) & 1u)) {
          atomicMin(&s_piv[buf], r);  // this thread's lowest candidate row
          offered = true;
        }
      }
    }
    __syncthreads();
    const int piv = s_piv[buf];
    // every thread has read s_piv[buf ^ 1] of the previous step before that
    // step's closing barrier, and the next step's atomics come after this
    // step's closing barrier, so the reset cannot race
    if (tid == 0) s_piv[buf ^ 1] = m;
    if (piv < m) {
      ++used_cnt;
      const uint32_t* prow = M + (size_t)piv * Wp;
      for (int q = 0, r = tid; r < m; ++q, r += nt) {
        if (r == piv) {
          used |= 1u << q;
          col_of_row[r] = c;
        } else if ((colmask >> q) & 1u) {
          uint32_t* row = M + (size_t)r * Wp;
          for (int k = 0; k < Wp; ++k) row[k] ^= prow[k];
        }
      }
    }
    // fast exit: no unused row with a syndrome 1 left, or full rank
    int un = 0;
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      if (!((used >> q) & 1u) && ((M[r * Wp + ws] >> bs) & 1u)) un = 1;
    }
    active = __syncthreads_or(un) && used_cnt < rank;
  }

  int bad = 0;
  for (int q = 0, r = tid; r < m; ++q, r += nt) {
    if (!((used >> q) & 1u) && ((M[r * Wp + ws] >> bs) & 1u)) bad = 1;
  }
  bad = __syncthreads_or(bad);
  uint8_t* x_lane = x0 + (size_t)lane * n;
  for (int j = tid; j < n; j += nt) x_lane[j] = 0;
  __syncthreads();
  for (int q = 0, r = tid; r < m; ++q, r += nt) {
    if ((used >> q) & 1u) {
      x_lane[col_of_row[r]] = (uint8_t)((M[r * Wp + ws] >> bs) & 1u);
    }
  }
  if (tid == 0) valid[lane] = !bad;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks m <= 32 * 1024 (each thread owns at most 32 rows) and that the
// shared memory, (m * Wp + m) * 4 bytes, fits the card's 227 KB.
int ldpc_osd0(const void* synd, const void* order, const void* packed_h, int m,
              int n, int Wp, int rank, int B, void* x0, void* valid,
              void* stream) {
  int threads = ((m + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = ((size_t)m * Wp + (size_t)m) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        osd0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osd0_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(synd), static_cast<const int*>(order),
      static_cast<const uint32_t*>(packed_h), m, n, Wp, rank,
      static_cast<uint8_t*>(x0), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

}  // extern "C"
