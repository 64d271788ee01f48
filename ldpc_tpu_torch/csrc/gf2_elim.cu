// K3', K4', K5': batched GF(2) Gauss-Jordan elimination for Hopper (sm_90a),
// one templated body behind three launchers.
//
// Replaces three Pallas TPU kernels of ldpc_tpu/ops/gf2_pallas.py that copy
// one elimination body and differ in two flags:
//   K3' ldpc_rref_export   <- _rref_export_kernel   (make_rref_export_solver)
//       full elimination to rank, exports [R | T s]          (kMask=0, kExport=1)
//   K4' ldpc_masked_solve  <- _masked_solve_kernel  (make_masked_solver)
//       lane l eliminates its first count[l] columns, reads out x0 and the
//       per-row "unused with syndrome 1" flags              (kMask=1, kExport=0)
//   K5' ldpc_masked_export <- _masked_export_kernel (make_masked_export_solver)
//       K4's masked elimination with K3's export             (kMask=1, kExport=1)
// Their plain PyTorch versions are ldpc_tpu_torch/ops/gf2_cuda.py::
// rref_export_reference, masked_solve_reference and masked_export_reference.
//
// The elimination is the one of csrc/osd0.cu (K2'): the working matrix is
// [H | s], bit-packed 32 columns per word; for each column in the lane's
// order, the pivot is the lowest-index unused row holding a 1 there; it is
// XORed into every other row holding a 1 (swap-free Gauss-Jordan) and the row
// remembers its pivot column. What the flags change:
//   - kMask: the lane stops after its own count[l] columns. The Pallas loop
//     runs every lane of a tile to the tile's largest count with an `active`
//     mask; masked steps change nothing, so a per-lane stop gives the same
//     state.
//   - !kMask (K3'): the lane stops at its own rank pivots. Once it has rank
//     pivots every unused row is zero on H, so the columns the Pallas tile
//     still walks for its other lanes change nothing.
//   - There is no syndrome fast exit here: callers read the pivot structure.
//   - kExport: the reduced words (m, Wp), each row's pivot column (n for an
//     unused row) and the used-row mask go to device memory.
//   - !kExport: x0 in original column coordinates (x0[col_of_row[r]] = the
//     row's syndrome bit, for used rows) and bad_row[r] = syndrome bit of an
//     unused row.
//
// What bounds it on the H100: as for K2', the sequential column loop. Each
// step is a column test over the thread's rows, one block-wide atomicMin and
// m*Wp word XORs: a lane is bound by the latency of the step's barrier, not
// by bytes or operations. Device memory is touched to load H and s once and
// to write the outputs once (the export is m*Wp words per lane).
//
// What the design does about it: one block per lane, the lane's working
// matrix in shared memory (6.2 KB at d=13, 41.6 KB for toric d=20; above
// 48 KB the launcher opts in, up to 227 KB); threads own rows, so the column
// test and the XOR need no communication. The pivot is a shared atomicMin
// into one of three rotating slots, which needs one barrier per step: slot
// j%3 is written in step j, read right after that step's barrier, and reset
// by thread 0 after the barrier of step j+1, before anyone can reach step
// j+3. Many lanes run concurrently on each SM to hide the barrier latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kMask, bool kExport>
__global__ void gf2_elim_kernel(const uint8_t* __restrict__ synd,  // (B, m)
                                const int* __restrict__ order,     // (B, n)
                                const int* __restrict__ count,     // (B,) kMask
                                const uint32_t* __restrict__ H,    // (m, Wp)
                                int m, int n, int Wp, int rank,
                                uint8_t* __restrict__ x0,          // (B, n)
                                bool* __restrict__ bad_row,        // (B, m)
                                uint32_t* __restrict__ M_out,      // (B, m, Wp)
                                int* __restrict__ colrow_out,      // (B, m)
                                bool* __restrict__ used_out) {     // (B, m)
  extern __shared__ uint32_t smem[];
  uint32_t* M = smem;                                            // (m, Wp)
  int* col_of_row = reinterpret_cast<int*>(M + (size_t)m * Wp);  // (m,)
  __shared__ int s_piv[3];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ws = n >> 5;                   // word of the syndrome column
  const uint32_t bs = (uint32_t)(n & 31);  // its bit
  const uint8_t* s_lane = synd + (size_t)lane * m;
  const int* ord = order + (size_t)lane * n;

  for (int idx = tid; idx < m * Wp; idx += nt) M[idx] = __ldg(H + idx);
  if (tid < 3) s_piv[tid] = m;
  __syncthreads();
  for (int r = tid; r < m; r += nt) {
    M[r * Wp + ws] |= (s_lane[r] ? 1u : 0u) << bs;
  }
  // thread tid owns rows tid, tid + nt, ...; bit q of `used` is row tid + q*nt
  uint32_t used = 0;
  int limit = n;
  if (kMask) {
    const int c = __ldg(count + lane);
    limit = c < 0 ? 0 : (c < n ? c : n);
  }
  int used_cnt = 0;
  for (int j = 0; j < limit && (kMask || used_cnt < rank); ++j) {
    const int c = __ldg(ord + j);
    const int w = c >> 5;
    const uint32_t bit = (uint32_t)(c & 31);
    const int slot = j % 3;
    uint32_t colmask = 0;
    bool offered = false;
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      if ((M[r * Wp + w] >> bit) & 1u) {
        colmask |= 1u << q;
        if (!offered && !((used >> q) & 1u)) {
          atomicMin(&s_piv[slot], r);  // this thread's lowest candidate row
          offered = true;
        }
      }
    }
    // also orders the previous step's XORs before this step's reads of the
    // new pivot row
    __syncthreads();
    const int piv = s_piv[slot];
    if (tid == 0) s_piv[(j + 2) % 3] = m;  // slot of step j-1, next used at j+2
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
  }
  __syncthreads();  // every row final before any thread reads another's

  if (kExport) {
    uint32_t* out = M_out + (size_t)lane * m * Wp;
    for (int idx = tid; idx < m * Wp; idx += nt) out[idx] = M[idx];
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      const bool u = (used >> q) & 1u;
      colrow_out[(size_t)lane * m + r] = u ? col_of_row[r] : n;
      used_out[(size_t)lane * m + r] = u;
    }
  } else {
    uint8_t* x_lane = x0 + (size_t)lane * n;
    for (int j = tid; j < n; j += nt) x_lane[j] = 0;
    __syncthreads();
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      const uint8_t sb = (uint8_t)((M[r * Wp + ws] >> bs) & 1u);
      if ((used >> q) & 1u) {
        x_lane[col_of_row[r]] = sb;
      }
      bad_row[(size_t)lane * m + r] = sb && !((used >> q) & 1u);
    }
  }
}

template <bool kMask, bool kExport>
int launch(const void* synd, const void* order, const void* count,
           const void* packed_h, int m, int n, int Wp, int rank, int B,
           void* x0, void* bad_row, void* M_out, void* colrow, void* used,
           void* stream) {
  int threads = ((m + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = ((size_t)m * Wp + (size_t)m) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf2_elim_kernel<kMask, kExport>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gf2_elim_kernel<kMask, kExport>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(synd), static_cast<const int*>(order),
          static_cast<const int*>(count),
          static_cast<const uint32_t*>(packed_h), m, n, Wp, rank,
          static_cast<uint8_t*>(x0), static_cast<bool*>(bad_row),
          static_cast<uint32_t*>(M_out), static_cast<int*>(colrow),
          static_cast<bool*>(used));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success). The
// caller checks m <= 32 * 1024 (each thread owns at most 32 rows) and that
// the shared memory, (m * Wp + m) * 4 bytes, fits the card's 227 KB.

// K3': M_out (B, m, Wp) words, col_of_row (B, m) int32 (n if unused), used (B, m)
int ldpc_rref_export(const void* synd, const void* order, const void* packed_h,
                     int m, int n, int Wp, int rank, int B, void* M_out,
                     void* col_of_row, void* used, void* stream) {
  return launch<false, true>(synd, order, nullptr, packed_h, m, n, Wp, rank, B,
                             nullptr, nullptr, M_out, col_of_row, used, stream);
}

// K4': x0 (B, n) uint8, bad_row (B, m) bool
int ldpc_masked_solve(const void* synd, const void* order, const void* count,
                      const void* packed_h, int m, int n, int Wp, int B,
                      void* x0, void* bad_row, void* stream) {
  return launch<true, false>(synd, order, count, packed_h, m, n, Wp, 0, B, x0,
                             bad_row, nullptr, nullptr, nullptr, stream);
}

// K5': as K3', for K4's masked elimination
int ldpc_masked_export(const void* synd, const void* order, const void* count,
                       const void* packed_h, int m, int n, int Wp, int B,
                       void* M_out, void* col_of_row, void* used,
                       void* stream) {
  return launch<true, true>(synd, order, count, packed_h, m, n, Wp, 0, B,
                            nullptr, nullptr, M_out, col_of_row, used, stream);
}

}  // extern "C"
