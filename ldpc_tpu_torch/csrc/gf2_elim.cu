// K2', K3', K4', K5': batched GF(2) Gauss-Jordan elimination for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of ldpc_tpu/ops/gf2_pallas.py that copy
// one elimination body and differ in three flags:
//   K2' ldpc_osd0          <- _osd0_kernel          (make_osd0_solver)
//       OSD-0: stops at the syndrome fast exit or at rank pivots, reads out
//       x0 and the lane's validity                (kMask=0, readout, kFast=1)
//   K3' ldpc_rref_export   <- _rref_export_kernel   (make_rref_export_solver)
//       full elimination to rank, exports [R | T s]          (kMask=0, export)
//   K4' ldpc_masked_solve  <- _masked_solve_kernel  (make_masked_solver)
//       lane l eliminates its first count[l] columns, reads out x0 and the
//       per-row "unused with syndrome 1" flags              (kMask=1, readout)
//   K5' ldpc_masked_export <- _masked_export_kernel (make_masked_export_solver)
//       K4's masked elimination with K3's export             (kMask=1, export)
// Their plain PyTorch versions are ldpc_tpu_torch/ops/gf2_cuda.py::
// osd0_reference, rref_export_reference, masked_solve_reference and
// masked_export_reference.
//
// The elimination: the working matrix is [H | s], bit-packed 32 columns per
// word; for each column in the lane's order, the pivot is the lowest-index
// unused row holding a 1 there; it is XORed into every other row holding a 1
// (swap-free Gauss-Jordan) and the row remembers its pivot column. K4' and
// K5' stop a lane after its own count[l] columns (the Pallas tile runs every
// lane to the tile's largest count with an `active` mask; masked steps change
// nothing); K3' stops a lane at rank pivots (after that every unused row is
// zero on H, so further columns change nothing); K2' stops as K3' does and
// also once no unused row holds a syndrome 1 (the fast exit of
// ldpc_tpu/ops/gf2.py::batched_rref(fast_exit=True)), and its lane is valid
// when none does at the end. The export is the reduced words (m, Wp), each
// row's pivot column (n for an unused row) and the used-row mask; the readout
// is x0 in original column coordinates (x0[col_of_row[r]] = the row's
// syndrome bit, for used rows) and, for K4', bad_row[r] = syndrome bit of an
// unused row.
//
// What bounds it on the H100: neither bytes nor operations but the latency
// and issue of the sequential column loop. K3' walks about 308 of the 313
// columns of a d=13 lane before it has rank (156) pivots; half the steps find
// no pivot, and a pivot clears only about 3.6 other rows, whose XOR touches
// about 2.5 nonzero words of the pivot row. So a step's fixed cost (the
// column test over every row, the pivot search, the loop) is the kernel.
// K4' on LSD's growth rounds walks about 5 columns a lane and K2' on the
// lanes BP fails about 6 (nearly every one a pivot) before the fast exit, so
// what they pay for is set-up and write-out around the steps.
//
// What the design does about it (the warp variant, the default):
//   - One warp per lane, several lanes to a block, no __syncthreads and no
//     shared atomic in a step: thread t owns rows t, t+32, ..., its used flags
//     are one 32-bit mask, and a step needs only warp primitives. The pivot is
//     the lowest unused row holding the bit: __reduce_min_sync of each
//     thread's lowest candidate row group, then __ffs of that group's
//     __ballot_sync. Each thread XORs the pivot row's nonzero words (one
//     __ballot_sync finds them) into its own rows that hold the bit;
//     __syncwarp orders the XORs before the next column test.
//   - K3'/K5' keep the lane's [H | s] in shared memory, rows padded with zero
//     rows to a multiple of 32 and at an odd stride, so a warp's row test is
//     RMAX loads with precomputed offsets, issued back to back, on 32
//     distinct banks. H comes in and the export goes out as flat coalesced
//     word streams. The lane's order row is read 32 columns at a time,
//     coalesced, and handed out by __shfl_sync, so no dependent load sits on
//     the step's path.
//   - K4' works on the lane's own columns only: every pivot and XOR on the
//     bits it reads out depends only on its first count columns and the
//     syndrome. Row r of the working matrix holds bit j = H[r, order[j]] and
//     the syndrome at bit count, built from var_chks (count x dv loads, pad
//     slots skipped) instead of copying H. A lane with count < 32 (the usual
//     growth round) keeps its matrix in registers, one word per owned row,
//     and broadcasts pivot rows by __shfl_sync; a wider lane builds its
//     ceil((count+1)/32)-word rows in shared memory and runs K3's step. The
//     choice is per lane, on the device, and warp-uniform. Each thread keeps
//     its rows' pivot positions in registers, so a narrow lane touches no
//     shared memory; the launch still reserves a full-width lane for the
//     wide ones (ldpc_masked_solve_resident_warps measures what that costs).
//   - K2' keeps the syndrome as one bit a row in a per-thread mask, beside
//     the matrix: a pivot whose syndrome bit is 1 toggles the bits of the rows
//     it is XORed into, and the fast exit is __any_sync(synd & ~used) after a
//     pivot. A lane walks its columns 32 at a time as K4's narrow lane does,
//     one register word a row, built from var_chks (thread j scatters column
//     j's checks into one shared-memory word a row). On the d=13 workload's
//     BP failures a lane walks about 6 columns and none of 6,148 more than
//     29, but one lane in a few thousand of a Monte-Carlo bucket or of toric
//     d=20 walks 33 to 41; such a lane starting again at full width (about
//     0.65 us a step) outlasts the rest of its launch, and a second register
//     word for every lane cost 35% at the main-path call. So every pivot
//     leaves a record in the lane's idle shared memory (each thread's rows
//     that took its XOR, and the pivot row), and a further 32-column word
//     first replays the recorded pivots, in registers. Only a lane with more
//     pivots than the record holds (48 at d=13) starts again, on the
//     full-width [H | 0] in shared memory with K3's step (the same pivots in
//     the same order, so the result does not depend on where a lane ran).
//     x0 is gathered as bits in shared memory and written once, coalesced,
//     zeros included.
//   - The block variant, kept for codes the warp cannot hold (m > 1024 rows,
//     or a lane above kLaneBudget of shared memory): one block per lane,
//     threads own rows, the pivot a shared atomicMin into one of three
//     rotating slots behind one __syncthreads a step (K2' adds the fast
//     exit's __syncthreads_or).
//   - The device variant, for codes above a block's shared memory (toric
//     d=31 and up): the block body with the lane's matrix and pivot columns
//     in device memory. K3'/K5' eliminate in place in their own output;
//     K2'/K4' in a scratch the wrapper allocates and hands out in lane
//     chunks. A step's __syncthreads also orders the block's global writes
//     before the next step's reads; the working matrix is never read through
//     the read-only path.
// ldpc_elim_variant tells the wrapper which variant a kernel takes for a code
// by default. K5' takes the warp variant only while four lanes share a
// block (kWarpExportMaskedBudget): with one lane to a block its one warp
// copies the whole matrix in and out, and K5' walks too few columns (its
// count, about 22 at d=13) to repay that; measured on the H100 it lost 4%
// to the block body at surface d=17 and 24% at toric d=20, where K3', which
// walks to rank, still gains 2x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxRows = 32 * 32;  // 32 rows a thread: one 32-bit used mask
// A lane's shared memory in the warp variant up to this many bytes (toric
// d=20 takes 46.5 KB); larger codes take the block variant.
constexpr size_t kLaneBudget = 48 * 1024;
// Lanes a block while 4 of them need no shared-memory opt-in; else one.
constexpr size_t kSmallBlock = 48 * 1024;
// K5' keeps the warp variant while 4 lanes share a block (see above).
constexpr size_t kWarpExportMaskedBudget = kSmallBlock / 4;
// Shared memory one H100 block can opt in to: the block variant's limit
constexpr size_t kBlockSmemLimit = 232448;
constexpr int kBlockMaxRows = 32 * 1024;  // 1024 threads owning 32 rows each

// Kernel ids of ldpc_elim_variant
enum Kernel { kRrefExport = 0, kMaskedSolve = 1, kMaskedExport = 2, kOsd0 = 3 };
// Variants, as ldpc_elim_variant returns them and the launchers take them
enum Variant { kVariantWarp = 0, kVariantBlock = 1, kVariantDevice = 2 };

struct Args {
  const uint8_t* synd;     // (B, m)
  const int* order;        // (B, n)
  const int* count;        // (B,) kMask
  const uint32_t* H;       // (m, Wp) packed [H | 0]
  const int* var_chks;     // (n, dv) checks of each bit, pad = m (K2', K4' warp)
  int m, n, Wp, dv, rank, B;
  uint8_t* x0;             // (B, n)
  bool* bad_row;           // (B, m) K4'
  bool* valid;             // (B,) K2'
  uint32_t* M_out;         // (B, m, Wp)
  int* colrow_out;         // (B, m)
  bool* used_out;          // (B, m)
  uint32_t* scratch;       // (B, m, Wp + 1) K2', K4' in the device variant
};

__device__ inline int lane_limit(const Args& a, int lane) {
  const int c = __ldg(a.count + lane);
  return c < 0 ? 0 : (c < a.n ? c : a.n);
}

// ---- block and device variants: one block per lane --------------------------

// kFast: K2's syndrome fast exit and validity. kDevice: the lane's matrix and
// pivot columns live in device memory (K3'/K5': the lane's own output; K2',
// K4': a.scratch), else in shared memory.
template <bool kMask, bool kExport, bool kFast, bool kDevice>
__global__ void gf2_block_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int m = a.m, n = a.n, Wp = a.Wp;
  const int lane = blockIdx.x;
  uint32_t* M;      // (m, Wp)
  int* col_of_row;  // (m,)
  if (!kDevice) {
    M = smem;
    col_of_row = reinterpret_cast<int*>(M + (size_t)m * Wp);
  } else if (kExport) {
    M = a.M_out + (size_t)lane * m * Wp;
    col_of_row = a.colrow_out + (size_t)lane * m;
  } else {
    M = a.scratch + (size_t)lane * ((size_t)m * Wp + m);
    col_of_row = reinterpret_cast<int*>(M + (size_t)m * Wp);
  }
  __shared__ int s_piv[3];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ws = n >> 5;                   // word of the syndrome column
  const uint32_t bs = (uint32_t)(n & 31);  // its bit
  const uint8_t* s_lane = a.synd + (size_t)lane * m;
  const int* ord = a.order + (size_t)lane * n;

  for (int idx = tid; idx < m * Wp; idx += nt) M[idx] = __ldg(a.H + idx);
  if (tid < 3) s_piv[tid] = m;
  __syncthreads();
  int unres = 0;
  for (int r = tid; r < m; r += nt) {
    const uint32_t sb = s_lane[r] ? 1u : 0u;
    M[r * Wp + ws] |= sb << bs;
    unres |= (int)sb;
  }
  // thread tid owns rows tid, tid + nt, ...; bit q of `used` is row tid + q*nt
  uint32_t used = 0;
  const int limit = kMask ? lane_limit(a, lane) : n;
  int used_cnt = 0;
  bool active = kMask || a.rank > 0;
  if (kFast) active = __syncthreads_or(unres) && active;
  for (int j = 0; j < limit && active; ++j) {
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
    // also orders the previous step's XORs (shared or device memory) before
    // this step's reads of the new pivot row
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
    if (!kMask) active = used_cnt < a.rank;
    if (kFast) {
      // fast exit: no unused row with a syndrome 1 left (a thread's own rows'
      // syndrome words change only under its own XORs)
      int un = 0;
      for (int q = 0, r = tid; r < m; ++q, r += nt) {
        if (!((used >> q) & 1u) && ((M[r * Wp + ws] >> bs) & 1u)) un = 1;
      }
      active = __syncthreads_or(un) && active;
    }
  }
  __syncthreads();  // every row final before any thread reads another's

  if (kExport) {
    if (!kDevice) {
      uint32_t* out = a.M_out + (size_t)lane * m * Wp;
      for (int idx = tid; idx < m * Wp; idx += nt) out[idx] = M[idx];
    }
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      const bool u = (used >> q) & 1u;
      a.colrow_out[(size_t)lane * m + r] = u ? col_of_row[r] : n;
      a.used_out[(size_t)lane * m + r] = u;
    }
  } else {
    uint8_t* x_lane = a.x0 + (size_t)lane * n;
    for (int j = tid; j < n; j += nt) x_lane[j] = 0;
    __syncthreads();
    int bad = 0;
    for (int q = 0, r = tid; r < m; ++q, r += nt) {
      const uint8_t sb = (uint8_t)((M[r * Wp + ws] >> bs) & 1u);
      const bool u = (used >> q) & 1u;
      if (u) x_lane[col_of_row[r]] = sb;
      if (kFast) {
        bad |= sb && !u;
      } else {
        a.bad_row[(size_t)lane * m + r] = sb && !u;
      }
    }
    if (kFast) {
      bad = __syncthreads_or(bad);
      if (tid == 0) a.valid[lane] = !bad;
    }
  }
}

// ---- warp variant: one warp per lane ---------------------------------------

// Row stride in shared memory: odd, so the 32 rows a warp tests at once
// (rows t + 32q, stride apart) fall in 32 distinct banks.
__host__ __device__ inline int row_stride(int words) { return words | 1; }

__host__ __device__ inline int row_groups(int m) { return (m + 31) >> 5; }

// A lane's shared memory in words: the matrix, its rows padded with zero
// rows to a multiple of 32 (so a row test needs no bound), then each row's
// pivot column; a multiple of 4 words.
__host__ __device__ inline size_t lane_words(int m, int Wp) {
  return ((size_t)32 * row_groups(m) * row_stride(Wp) + (size_t)m + 3) & ~(size_t)3;
}

// K4's lane in words: only a wide lane's matrix, at most Wp words a row
// (each thread keeps its own rows' pivot columns in registers).
__host__ __device__ inline size_t solve_lane_words(int m, int Wp) {
  return (size_t)32 * row_groups(m) * row_stride(Wp);
}

inline int lanes_per_block(size_t lane_bytes) {
  return 4 * lane_bytes <= kSmallBlock ? 4 : 1;
}

// Where thread t's rows start in a lane's shared matrix of row stride S:
// groups past R repeat group R - 1, so the row test loads RMAX words
// unconditionally and `mask` drops the repeats. Set once per lane, so a
// step spends no instructions on addresses.
template <int RMAX>
struct RowGroups {
  int off[RMAX];
  uint32_t mask;

  __device__ RowGroups(int t, int S, int R) {
#pragma unroll
    for (int q = 0; q < RMAX; ++q) off[q] = ((q < R ? q : R - 1) * 32 + t) * S;
    mask = R < 32 ? (1u << R) - 1u : ~0u;
  }
};

// One column step on a shared-memory matrix M (32 R rows, rows m and above
// zero, W words a row at stride S): the column is bit `bit` of word w. Finds
// the pivot, marks it used in its owner's mask and XORs the pivot row's
// nonzero words into every other row holding the bit, each thread into its
// own rows. Returns the pivot row, or -1. With kSynd the syndrome is not in
// M but one bit a row in `synd` (bit q: row t + 32q), and follows the XORs.
template <int RMAX, bool kSynd = false>
__device__ inline int warp_step(uint32_t* M, int S, int W, const RowGroups<RMAX>& g,
                                int t, int w, uint32_t bit, uint32_t& used,
                                uint32_t* synd = nullptr) {
  // bit q: row t + 32q holds a 1 in the column; the loads issue back to back
  uint32_t word[RMAX];
#pragma unroll
  for (int q = 0; q < RMAX; ++q) word[q] = M[g.off[q] + w];
  uint32_t hold = 0;
#pragma unroll
  for (int q = 0; q < RMAX; ++q) hold |= ((word[q] >> bit) & 1u) << q;
  hold &= g.mask;
  const uint32_t cand = hold & ~used;
  // lowest row group holding a candidate, then its lowest thread
  const unsigned qmin = __reduce_min_sync(kFull, cand ? (unsigned)(__ffs(cand) - 1) : 32u);
  if (qmin == 32u) return -1;
  const int pt = __ffs(__ballot_sync(kFull, (cand >> qmin) & 1u)) - 1;
  const int piv = pt + 32 * (int)qmin;
  if (t == pt) {
    used |= 1u << qmin;
    hold &= ~(1u << qmin);
  }
  if (kSynd) {
    // the pivot row's syndrome bit goes into every row it is XORed into
    if (__shfl_sync(kFull, (*synd >> qmin) & 1u, pt)) *synd ^= hold;
  }
  const uint32_t* prow = M + piv * S;
  if (W <= 32) {
    const uint32_t nz = __ballot_sync(kFull, t < W && prow[t] != 0u);
    for (; hold; hold &= hold - 1) {
      uint32_t* row = M + (t + 32 * (__ffs(hold) - 1)) * S;
      for (uint32_t z = nz; z; z &= z - 1) {
        const int k = __ffs(z) - 1;
        row[k] ^= prow[k];
      }
    }
  } else {
    for (; hold; hold &= hold - 1) {
      uint32_t* row = M + (t + 32 * (__ffs(hold) - 1)) * S;
      for (int k = 0; k < W; ++k) row[k] ^= prow[k];
    }
  }
  __syncwarp();
  return piv;
}

// Copy an (m, W) row-major array between device memory (stride W) and the
// lane's shared matrix (stride S) with the 32 threads of a warp: thread t
// takes flat words t, t+32, ..., so each pass is one coalesced 128-byte
// access, and the loads of a pass do not wait on each other.
template <bool kIn>
__device__ inline void warp_copy(uint32_t* M, int S, uint32_t* dst_g,
                                 const uint32_t* src_g, int m, int W, int t) {
  const int dr = 32 / W, dk = 32 - dr * W;  // a pass advances 32 words
  int r = t / W, k = t - (t / W) * W;
#pragma unroll 8
  for (int i = t; i < m * W; i += 32) {
    if (kIn) {
      M[r * S + k] = __ldg(src_g + i);
    } else {
      dst_g[i] = M[r * S + k];
    }
    r += dr;
    k += dk;
    if (k >= W) {
      k -= W;
      ++r;
    }
  }
}

// Bit j of row[q] = H[t + 32q, col_j] for the warp's `cols` <= 32 columns,
// thread j holding column col_j in `col`: thread t loads its column's checks
// from var_chks, the warp walks the columns and the thread owning each check
// sets its bit. Every other bit of row[] is cleared.
template <int RMAX>
__device__ inline void build_word(const Args& a, int col, int cols, int t,
                                  uint32_t (&row)[RMAX]) {
#pragma unroll
  for (int q = 0; q < RMAX; ++q) row[q] = 0;
  for (int k = 0; k < a.dv; ++k) {
    const int chk_t = (t < cols) ? __ldg(a.var_chks + (size_t)col * a.dv + k) : a.m;
    for (int j = 0; j < cols; ++j) {
      const int chk = __shfl_sync(kFull, chk_t, j);
      if (chk < a.m && (chk & 31) == t) {
        const int qq = chk >> 5;
#pragma unroll
        for (int q = 0; q < RMAX; ++q) {
          if (q == qq) row[q] |= 1u << j;
        }
      }
    }
  }
}

// Thread t's word of its row group q (warp-uniform)
template <int RMAX>
__device__ inline uint32_t get_group(const uint32_t (&row)[RMAX], int q) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    if (i == q) v = row[i];
  }
  return v;
}

// XOR `prow` into the thread's rows named by `hold` (bit q: row t + 32q)
template <int RMAX>
__device__ inline void xor_rows(uint32_t (&row)[RMAX], uint32_t hold, uint32_t prow) {
#pragma unroll
  for (int q = 0; q < RMAX; ++q) {
    if ((hold >> q) & 1u) row[q] ^= prow;
  }
}

// One column step on a matrix of one word a row kept in registers (row[q]:
// row t + 32q): the column is bit j. Finds the pivot, marks it used in its
// owner's mask and XORs its word into every other row holding the bit.
// Returns whether there was a pivot; then thread `pt` owns it as its row
// group `qmin`, and `hold` has the thread's rows that took the XOR.
template <int RMAX>
__device__ inline bool register_step(uint32_t (&row)[RMAX], int j, int t, uint32_t& used,
                                     int& pt, unsigned& qmin, uint32_t& hold) {
  hold = 0;
#pragma unroll
  for (int q = 0; q < RMAX; ++q) hold |= ((row[q] >> j) & 1u) << q;
  const uint32_t cand = hold & ~used;
  qmin = __reduce_min_sync(kFull, cand ? (unsigned)(__ffs(cand) - 1) : 32u);
  if (qmin == 32u) return false;
  pt = __ffs(__ballot_sync(kFull, (cand >> qmin) & 1u)) - 1;
  const uint32_t prow = __shfl_sync(kFull, get_group<RMAX>(row, (int)qmin), pt);
  if (t == pt) {
    used |= 1u << qmin;
    hold &= ~(1u << qmin);
  }
  xor_rows<RMAX>(row, hold, prow);
  return true;
}

// Bit j of row[q] = H[t + 32q, col_j] for `cols` <= 32 columns, thread j
// holding column col_j in `col`: thread j scatters its column's checks (from
// var_chks) into one word a row of the lane's shared memory `words` (32 R of
// them), then every thread takes its own rows.
template <int RMAX>
__device__ inline void scatter_word(const Args& a, uint32_t* words, int R, int col,
                                    int cols, int t, uint32_t (&row)[RMAX]) {
  for (int q = 0; q < R; ++q) words[t + 32 * q] = 0;
  __syncwarp();
  if (t < cols) {
    for (int k = 0; k < a.dv; ++k) {
      const int chk = __ldg(a.var_chks + (size_t)col * a.dv + k);
      if (chk < a.m) atomicOr(&words[chk], 1u << t);
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < RMAX; ++q) row[q] = (q < R) ? words[t + 32 * q] : 0u;
}

// Thread t's row group q (warp-uniform) takes the value v
template <int RMAX>
__device__ inline void set_group(int (&arr)[RMAX], int q, int v) {
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    if (i == q) arr[i] = v;
  }
}

// The columns of a lane's order row, 32 at a time: thread t holds column
// j0 + t of the current 32 and of the next, read coalesced, so a step gets
// its column by __shfl_sync with no dependent load on its path.
struct OrderWindow {
  const int* ord;
  int limit, t, cur, nxt;

  __device__ OrderWindow(const int* ord_, int limit_, int t_)
      : ord(ord_), limit(limit_), t(t_) {
    cur = (t < limit) ? __ldg(ord + t) : 0;
    nxt = (32 + t < limit) ? __ldg(ord + 32 + t) : 0;
  }

  // column j; called for j = 0, 1, 2, ... by the whole warp
  __device__ int at(int j) {
    if (j > 0 && (j & 31) == 0) {
      cur = nxt;
      nxt = (j + 32 + t < limit) ? __ldg(ord + j + 32 + t) : 0;
    }
    return __shfl_sync(kFull, cur, j & 31);
  }
};

// K3' (kMask=0) and K5' (kMask=1): full-width [H | s] in shared memory,
// exported in original column coordinates. RMAX >= ceil(m/32).
template <bool kMask, int RMAX>
__global__ void __launch_bounds__(128, 8) gf2_warp_export_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int t = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int lane = blockIdx.x * (blockDim.x >> 5) + wib;
  if (lane >= a.B) return;  // whole warps only; no block barrier follows
  const int m = a.m, n = a.n, Wp = a.Wp;
  const int S = row_stride(Wp);
  const int R = row_groups(m);
  uint32_t* M = smem + (size_t)wib * lane_words(m, Wp);
  int* col_of_row = reinterpret_cast<int*>(M + (size_t)32 * R * S);

  warp_copy<true>(M, S, nullptr, a.H, m, Wp, t);
  for (int i = m * S + t; i < 32 * R * S; i += 32) M[i] = 0;  // the pad rows
  __syncwarp();
  const int ws = n >> 5;
  const uint32_t bs = (uint32_t)(n & 31);
  const uint8_t* s_lane = a.synd + (size_t)lane * m;
  for (int r = t; r < m; r += 32) M[r * S + ws] |= (s_lane[r] ? 1u : 0u) << bs;
  __syncwarp();

  const int limit = kMask ? lane_limit(a, lane) : n;
  const int* ord = a.order + (size_t)lane * n;
  const RowGroups<RMAX> groups(t, S, R);
  OrderWindow window(ord, limit, t);
  uint32_t used = 0;
  int used_cnt = 0;
  for (int j = 0; j < limit && (kMask || used_cnt < a.rank); ++j) {
    const int c = window.at(j);
    const int piv = warp_step<RMAX>(M, S, Wp, groups, t, c >> 5, (uint32_t)(c & 31), used);
    if (piv >= 0) {
      ++used_cnt;
      if (t == (piv & 31)) col_of_row[piv] = c;
    }
  }

  warp_copy<false>(M, S, a.M_out + (size_t)lane * m * Wp, nullptr, m, Wp, t);
#pragma unroll
  for (int q = 0; q < RMAX; ++q) {
    const int r = t + 32 * q;
    if (r < m) {
      const bool u = (used >> q) & 1u;
      a.colrow_out[(size_t)lane * m + r] = u ? col_of_row[r] : n;
      a.used_out[(size_t)lane * m + r] = u;
    }
  }
}

// K4': the lane's own count columns plus the syndrome. RMAX >= ceil(m/32)
// bounds the rows a thread owns (the register matrix of a narrow lane).
template <int RMAX>
__global__ void __launch_bounds__(128, (RMAX <= 8 ? 8 : 1))
    gf2_warp_solve_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int t = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int lane = blockIdx.x * (blockDim.x >> 5) + wib;
  if (lane >= a.B) return;  // whole warps only; no block barrier follows
  const int m = a.m, n = a.n;
  const int R = row_groups(m);
  const int c = lane_limit(a, lane);
  const int* ord = a.order + (size_t)lane * n;
  const uint8_t* s_lane = a.synd + (size_t)lane * m;
  uint32_t* M = smem + (size_t)wib * solve_lane_words(m, a.Wp);

  const int Wc = (c + 32) >> 5;  // words of the lane's c columns + syndrome
  const int S = row_stride(Wc);
  const int sw = c >> 5;                   // word of the syndrome bit
  const uint32_t sbit = (uint32_t)(c & 31);
  uint32_t row[RMAX];  // narrow lane: row t + 32q; wide lane: one word of it
  int col_of_row[RMAX] = {};  // row t + 32q's pivot, a position in the lane's order
  uint32_t used = 0;

  // Word wi of every owned row: bit j - 32 wi set where H[r, order[j]] = 1,
  // for the lane's columns j in [32 wi, min(32 wi + 32, c)).
  for (int wi = 0; wi < Wc; ++wi) {
    const int j0 = 32 * wi;
    const int cols = (c - j0 < 32) ? c - j0 : 32;
    const int col = (t < cols) ? __ldg(ord + j0 + t) : 0;
    build_word<RMAX>(a, col, cols, t, row);
    if (wi == sw) {
#pragma unroll
      for (int q = 0; q < RMAX; ++q) {
        const int r = t + 32 * q;
        if (r < m && s_lane[r]) row[q] |= 1u << sbit;
      }
    }
    if (Wc > 1) {  // wide lane: the word goes to shared memory, pad rows too
#pragma unroll
      for (int q = 0; q < RMAX; ++q) {
        if (q < R) M[(t + 32 * q) * S + wi] = row[q];
      }
    }
  }

  if (Wc == 1) {
    // narrow lane: the matrix stays in registers
    for (int j = 0; j < c; ++j) {
      int pt;
      unsigned qmin;
      uint32_t hold;
      if (register_step<RMAX>(row, j, t, used, pt, qmin, hold) && t == pt) {
        set_group<RMAX>(col_of_row, (int)qmin, j);
      }
    }
  } else {
    // wide lane: K3's step on the shared-memory matrix
    __syncwarp();
    const RowGroups<RMAX> groups(t, S, R);
    for (int j = 0; j < c; ++j) {
      const int piv = warp_step<RMAX>(M, S, Wc, groups, t, j >> 5, (uint32_t)(j & 31), used);
      if (piv >= 0 && t == (piv & 31)) set_group<RMAX>(col_of_row, piv >> 5, j);
    }
#pragma unroll
    for (int q = 0; q < RMAX; ++q) {
      row[q] = (q < R) ? M[(t + 32 * q) * S + sw] : 0;  // own rows' syndrome word
    }
  }

  // read out: x0 is zero but where a used row's syndrome bit is 1
  uint8_t* x_lane = a.x0 + (size_t)lane * n;
  for (int j = t; j < n; j += 32) x_lane[j] = 0;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < RMAX; ++q) {
    const int r = t + 32 * q;
    if (r < m) {
      const bool sb = (row[q] >> sbit) & 1u;
      const bool u = (used >> q) & 1u;
      if (u && sb) x_lane[__ldg(ord + col_of_row[q])] = 1;
      a.bad_row[(size_t)lane * m + r] = sb && !u;
    }
  }
}

// Pivots whose record fits a K2' lane's matrix words beside the 32 R words a
// column word is scattered into: 32 masks and the pivot row, each.
__host__ __device__ inline int osd0_history_pivots(int m, int Wp) {
  return (32 * row_groups(m) * (row_stride(Wp) - 1)) / 33;
}

// K2's lane in words: the full-width matrix of a lane that restarts (before
// that: a column word's scatter and the pivots' record), then the bits of
// x0 (n <= 32 Wp of them); a multiple of 4 words.
__host__ __device__ inline size_t osd0_lane_words(int m, int Wp) {
  return ((size_t)32 * row_groups(m) * row_stride(Wp) + (size_t)Wp + 3) & ~(size_t)3;
}

// K2': OSD-0 with the syndrome fast exit. RMAX >= ceil(m/32).
template <int RMAX>
__global__ void __launch_bounds__(128, (RMAX <= 8 ? 8 : 1))
    gf2_warp_osd0_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int t = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int lane = blockIdx.x * (blockDim.x >> 5) + wib;
  if (lane >= a.B) return;  // whole warps only; no block barrier follows
  const int m = a.m, n = a.n, Wp = a.Wp;
  const int R = row_groups(m);
  const int S = row_stride(Wp);
  const int* ord = a.order + (size_t)lane * n;
  const uint8_t* s_lane = a.synd + (size_t)lane * m;
  uint32_t* M = smem + (size_t)wib * osd0_lane_words(m, Wp);
  uint32_t* xbits = M + (size_t)32 * R * S;  // (Wp,) x0, a bit a column

  uint32_t synd0 = 0;  // bit q: the syndrome of row t + 32q
#pragma unroll
  for (int q = 0; q < RMAX; ++q) {
    const int r = t + 32 * q;
    if (r < m && s_lane[r]) synd0 |= 1u << q;
  }
  uint32_t synd = synd0;
  uint32_t used = 0;
  int col_of_row[RMAX] = {};  // row t + 32q's pivot column
  int used_cnt = 0;
  // a lane goes on while an unused row holds a syndrome 1 and rank allows
  bool active = __any_sync(kFull, synd != 0u) && a.rank > 0;
  bool restart = false;
  if (active) {
    // The lane's columns 32 at a time, one register word a row. Every pivot
    // leaves a record in the lane's shared memory (each thread's rows that
    // took its XOR, and the pivot row), and a later word first takes the
    // recorded pivots' XORs in their order, which brings its columns to
    // where the elimination stands.
    uint32_t* history = M + 32 * R;  // 33 words a pivot
    const int room = osd0_history_pivots(m, Wp);
    for (int j0 = 0; j0 < n && active && !restart; j0 += 32) {
      const int cols = (n - j0 < 32) ? n - j0 : 32;
      const int col = (t < cols) ? __ldg(ord + j0 + t) : 0;
      uint32_t row[RMAX];
      scatter_word<RMAX>(a, M, R, col, cols, t, row);
      for (int k = 0; k < used_cnt; ++k) {
        const int piv = (int)history[33 * k + 32];
        const uint32_t prow = __shfl_sync(kFull, get_group<RMAX>(row, piv >> 5), piv & 31);
        xor_rows<RMAX>(row, history[33 * k + t], prow);
      }
      for (int j = 0; j < cols && active; ++j) {
        int pt;
        unsigned qmin;
        uint32_t hold;
        const int c = __shfl_sync(kFull, col, j);
        if (!register_step<RMAX>(row, j, t, used, pt, qmin, hold)) continue;
        if (used_cnt == room) {
          restart = true;  // no room for this pivot's record
          break;
        }
        history[33 * used_cnt + t] = hold;
        if (t == pt) {
          history[33 * used_cnt + 32] = (uint32_t)(pt + 32 * (int)qmin);
          set_group<RMAX>(col_of_row, (int)qmin, c);
        }
        if (__shfl_sync(kFull, (synd >> qmin) & 1u, pt)) synd ^= hold;
        ++used_cnt;
        active = __any_sync(kFull, (synd & ~used) != 0u) && used_cnt < a.rank;
      }
      __syncwarp();  // the records, before the next word's replay reads them
    }
  }
  if (restart) {
    // more pivots than the record holds: start again on the full-width
    // [H | 0] in shared memory (the same pivots, then the ones that follow)
    active = true;
    synd = synd0;
    used = 0;
    used_cnt = 0;
    warp_copy<true>(M, S, nullptr, a.H, m, Wp, t);
    for (int i = m * S + t; i < 32 * R * S; i += 32) M[i] = 0;  // the pad rows
    __syncwarp();
    const RowGroups<RMAX> groups(t, S, R);
    OrderWindow window(ord, n, t);
    for (int j = 0; j < n && active; ++j) {
      const int c = window.at(j);
      const int piv = warp_step<RMAX, true>(M, S, Wp, groups, t, c >> 5, (uint32_t)(c & 31),
                                            used, &synd);
      if (piv < 0) continue;
      if (t == (piv & 31)) set_group<RMAX>(col_of_row, piv >> 5, c);
      ++used_cnt;
      active = __any_sync(kFull, (synd & ~used) != 0u) && used_cnt < a.rank;
    }
  }

  // read out: x0[col_of_row[r]] = the syndrome bit of a used row, gathered
  // as bits and written once, zeros included
  for (int w = t; w < Wp; w += 32) xbits[w] = 0;
  __syncwarp();
  for (uint32_t ones = synd & used; ones; ones &= ones - 1) {
    int c = 0;
    const int qq = __ffs(ones) - 1;
#pragma unroll
    for (int q = 0; q < RMAX; ++q) {
      if (q == qq) c = col_of_row[q];
    }
    atomicOr(&xbits[c >> 5], 1u << (c & 31));
  }
  __syncwarp();
  uint8_t* x_lane = a.x0 + (size_t)lane * n;
  for (int j = t; j < n; j += 32) x_lane[j] = (uint8_t)((xbits[j >> 5] >> (j & 31)) & 1u);
  const bool bad = __any_sync(kFull, (synd & ~used) != 0u);
  if (t == 0) a.valid[lane] = !bad;
}

// ---- launchers ----------------------------------------------------------

using WarpKernel = void (*)(const Args);

// Bytes of shared memory a lane of a warp-variant kernel takes.
size_t warp_lane_bytes(int kernel, int m, int Wp) {
  const size_t words = kernel == kMaskedSolve ? solve_lane_words(m, Wp)
                       : kernel == kOsd0      ? osd0_lane_words(m, Wp)
                                              : lane_words(m, Wp);
  return words * sizeof(uint32_t);
}

// Bytes of shared memory a lane takes in the block variant.
size_t block_lane_bytes(int m, int Wp) {
  return ((size_t)m * Wp + (size_t)m) * sizeof(uint32_t);
}

// Raise a kernel's dynamic shared memory above the default 48 KB where
// needed: 0, or the error (a variant forced on a code above the card's
// opt-in limit fails here), cleared so that it is not read again as the
// next launch's error.
template <typename KernelFn>
int raise_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// The block's shared memory for lanes of lane_bytes, raised where needed:
// 0, or the error.
int warp_block_smem(WarpKernel kernel, size_t lane_bytes, size_t* smem) {
  *smem = (size_t)lanes_per_block(lane_bytes) * lane_bytes;
  return raise_smem(kernel, *smem);
}

int launch_warp(WarpKernel kernel, const Args& a, size_t lane_bytes, cudaStream_t stream) {
  if (a.m > kWarpMaxRows) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int err = warp_block_smem(kernel, lane_bytes, &smem);
  if (err) return err;
  const int lpb = lanes_per_block(lane_bytes);
  const int blocks = (a.B + lpb - 1) / lpb;
  kernel<<<blocks, 32 * lpb, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One block per lane, the lane's matrix in shared memory or (kDevice) in
// device memory
template <bool kMask, bool kExport, bool kFast, bool kDevice>
int launch_block_in(const Args& a, cudaStream_t stream) {
  if (a.m > kBlockMaxRows) return (int)cudaErrorInvalidValue;
  int threads = ((a.m + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = kDevice ? 0 : block_lane_bytes(a.m, a.Wp);
  const int err = raise_smem(gf2_block_kernel<kMask, kExport, kFast, kDevice>, smem);
  if (err) return err;
  gf2_block_kernel<kMask, kExport, kFast, kDevice><<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMask, bool kExport, bool kFast>
int launch_block(const Args& a, int variant, cudaStream_t stream) {
  if (variant == kVariantDevice) return launch_block_in<kMask, kExport, kFast, true>(a, stream);
  return launch_block_in<kMask, kExport, kFast, false>(a, stream);
}

// The instance whose RMAX holds row_groups(m)
template <bool kMask>
WarpKernel export_kernel(int m) {
  const int R = row_groups(m);
  if (R <= 4) return gf2_warp_export_kernel<kMask, 4>;
  if (R <= 8) return gf2_warp_export_kernel<kMask, 8>;
  if (R <= 16) return gf2_warp_export_kernel<kMask, 16>;
  return gf2_warp_export_kernel<kMask, 32>;
}

WarpKernel solve_kernel(int m) {
  const int R = row_groups(m);
  if (R <= 4) return gf2_warp_solve_kernel<4>;
  if (R <= 8) return gf2_warp_solve_kernel<8>;
  if (R <= 16) return gf2_warp_solve_kernel<16>;
  return gf2_warp_solve_kernel<32>;
}

WarpKernel osd0_kernel(int m) {
  const int R = row_groups(m);
  if (R <= 4) return gf2_warp_osd0_kernel<4>;
  if (R <= 8) return gf2_warp_osd0_kernel<8>;
  if (R <= 16) return gf2_warp_osd0_kernel<16>;
  return gf2_warp_osd0_kernel<32>;
}

template <bool kMask>
int launch_export(const Args& a, int variant, cudaStream_t st) {
  if (variant != kVariantWarp) return launch_block<kMask, true, false>(a, variant, st);
  const int kernel = kMask ? kMaskedExport : kRrefExport;
  return launch_warp(export_kernel<kMask>(a.m), a, warp_lane_bytes(kernel, a.m, a.Wp), st);
}

Args make_args(const void* synd, const void* order, const void* count,
               const void* packed_h, const void* var_chks, int m, int n,
               int Wp, int dv, int rank, int B) {
  Args a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.order = static_cast<const int*>(order);
  a.count = static_cast<const int*>(count);
  a.H = static_cast<const uint32_t*>(packed_h);
  a.var_chks = static_cast<const int*>(var_chks);
  a.m = m;
  a.n = n;
  a.Wp = Wp;
  a.dv = dv;
  a.rank = rank;
  a.B = B;
  a.x0 = nullptr;
  a.bad_row = nullptr;
  a.valid = nullptr;
  a.M_out = nullptr;
  a.colrow_out = nullptr;
  a.used_out = nullptr;
  a.scratch = nullptr;
  return a;
}

}  // namespace

extern "C" {

// The variant `kernel` (0 K3', 1 K4', 2 K5', 3 K2') takes for an (m, n) code
// by default: 0 warp, while the code has at most 1024 rows and a lane takes
// at most kLaneBudget bytes of shared memory (K5': kWarpExportMaskedBudget);
// else 1 block, while the lane's (m * Wp + m) * 4 bytes fit a block's shared
// memory; else 2 device.
int ldpc_elim_variant(int kernel, int m, int n) {
  const int Wp = (n + 32) / 32;  // ceil((n + 1) / 32)
  const size_t budget = kernel == kMaskedExport ? kWarpExportMaskedBudget : kLaneBudget;
  if (m <= kWarpMaxRows && warp_lane_bytes(kernel, m, Wp) <= budget) return kVariantWarp;
  return block_lane_bytes(m, Wp) <= kBlockSmemLimit ? kVariantBlock : kVariantDevice;
}

// Warps of K4's warp variant resident on one SM (the runtime's occupancy
// calculator) for m rows when a lane reserves shared memory for rows of
// cap_words words (the launch reserves Wp; 0: none, as a launch of narrow
// lanes only could), or the negative CUDA error. A measurement aid: no
// launch reserves less than Wp.
int ldpc_masked_solve_resident_warps(int m, int cap_words) {
  const size_t lane_bytes = cap_words > 0 ? warp_lane_bytes(kMaskedSolve, m, cap_words) : 0;
  const WarpKernel kernel = solve_kernel(m);
  size_t smem = 0;
  int err = warp_block_smem(kernel, lane_bytes, &smem);
  const int lpb = lanes_per_block(lane_bytes);
  int blocks = 0;
  if (!err) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * lpb, smem);
  }
  return err ? -err : blocks * lpb;
}

// Each launcher takes `variant` (0 warp, 1 block, 2 device) and returns
// cudaGetLastError() after the launch (0 on success), or the error of
// raising the block's shared-memory limit (a variant forced on a code it
// cannot hold), or cudaErrorInvalidValue above the variant's rows (warp
// 1024, block and device 32 * 1024). In the device variant K3' and K5'
// eliminate in place in M_out and col_of_row; K2' and K4' need `scratch`,
// B * (m * Wp + m) words. Nothing synchronises.

// K2': x0 (B, n) uint8, valid (B,) bool. The warp variant reads var_chks
// (n, dv) and, for a lane that restarts, packed_h.
int ldpc_osd0(const void* synd, const void* order, const void* packed_h,
              const void* var_chks, int m, int n, int Wp, int dv, int rank, int B,
              int variant, void* x0, void* valid, void* scratch, void* stream) {
  Args a = make_args(synd, order, nullptr, packed_h, var_chks, m, n, Wp, dv, rank, B);
  a.x0 = static_cast<uint8_t*>(x0);
  a.valid = static_cast<bool*>(valid);
  a.scratch = static_cast<uint32_t*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant != kVariantWarp) return launch_block<false, false, true>(a, variant, st);
  return launch_warp(osd0_kernel(m), a, warp_lane_bytes(kOsd0, m, Wp), st);
}

// K3': M_out (B, m, Wp) words, col_of_row (B, m) int32 (n if unused), used (B, m)
int ldpc_rref_export(const void* synd, const void* order, const void* packed_h,
                     int m, int n, int Wp, int rank, int B, int variant,
                     void* M_out, void* col_of_row, void* used, void* stream) {
  Args a = make_args(synd, order, nullptr, packed_h, nullptr, m, n, Wp, 0, rank, B);
  a.M_out = static_cast<uint32_t*>(M_out);
  a.colrow_out = static_cast<int*>(col_of_row);
  a.used_out = static_cast<bool*>(used);
  return launch_export<false>(a, variant, static_cast<cudaStream_t>(stream));
}

// K4': x0 (B, n) uint8, bad_row (B, m) bool. The warp variant reads
// var_chks (n, dv), the others packed_h.
int ldpc_masked_solve(const void* synd, const void* order, const void* count,
                      const void* packed_h, const void* var_chks, int m, int n,
                      int Wp, int dv, int B, int variant, void* x0,
                      void* bad_row, void* scratch, void* stream) {
  Args a = make_args(synd, order, count, packed_h, var_chks, m, n, Wp, dv, 0, B);
  a.x0 = static_cast<uint8_t*>(x0);
  a.bad_row = static_cast<bool*>(bad_row);
  a.scratch = static_cast<uint32_t*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant != kVariantWarp) return launch_block<true, false, false>(a, variant, st);
  return launch_warp(solve_kernel(m), a, warp_lane_bytes(kMaskedSolve, m, Wp), st);
}

// K5': as K3', for K4's masked elimination
int ldpc_masked_export(const void* synd, const void* order, const void* count,
                       const void* packed_h, int m, int n, int Wp, int B,
                       int variant, void* M_out, void* col_of_row, void* used,
                       void* stream) {
  Args a = make_args(synd, order, count, packed_h, nullptr, m, n, Wp, 0, 0, B);
  a.M_out = static_cast<uint32_t*>(M_out);
  a.colrow_out = static_cast<int*>(col_of_row);
  a.used_out = static_cast<bool*>(used);
  return launch_export<true>(a, variant, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
