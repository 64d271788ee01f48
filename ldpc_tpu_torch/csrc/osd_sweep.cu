// The OSD-w candidate sweep for Hopper (sm_90a): ldpc_osd_sweep.
//
// Replaces no Pallas kernel: the JAX package sweeps the candidates with XLA
// einsums (ldpc_tpu/ops/osd.py:302-337). Its plain PyTorch version is
// ldpc_tpu_torch/ops/osd.py::sweep_reference, which the port ran on the card
// until this kernel: an elementwise launch a check row for each of the
// baseline, the singles and the patterns (weigh_rows), over a materialised
// (lanes, candidates, m) tensor, in chunks of lanes.
//
// What it computes, for each lane of K3's export [R | T s] (ldpc_rref_export):
// the OSD-0 decoding (x0[col_of_row[r]] = s_r on the used rows) and the OSD-w
// decoding, the first minimum-weight candidate in the reference's enumeration
// order: the baseline (no column flipped), then (OSD-CS only) every single
// non-pivot column in reliability order, then every pattern of the pattern
// table over the first W non-pivot columns. A candidate flipping columns F
// has the pivot part y = s ^ XOR_{c in F} R[:, c]; its score is the weights
// of its pivot rows summed in row order, one addition a row in the dtype
// (acc = term_0, then acc + term_r), then the flipped columns' weights: a
// single's one, a pattern's slots w = 0..W-1 in turn, adding +0.0 for a slot
// it leaves. A row's weight is selected, never multiplied, so a weight of
// +inf (a channel probability of 0) never makes a NaN. These are the
// reference's additions in its order, so the two agree bit for bit, ties
// included: the winner is the first candidate whose score no earlier
// candidate's exceeds (strict <, as the reference's running best).
//
// What bounds it on the H100: at toric d=20 and 4,096 lanes it reads the
// export once, 4,096 x 41,600 B = 170 MB (0.051 ms at 3.35 TB/s), and takes
// 4,096 x 412 x 400 = 675 M row steps (about 0.02 ms at 33.5 T/s), so the
// bytes bound it. The plain version moved the unpacked bits and the score
// terms through device memory several times a row and launched once a row.
// In practice the row steps' instructions and a block's life decide: a
// block holds its lane's 42 KB of shared memory until its slowest warp ends.
//
// What the design does about it:
//   - One block a lane, a thread a candidate (striding where there are more
//     candidates than 1,024 threads), all threads walking the same row in
//     step. Every candidate runs the same instructions a row, so no warp
//     diverges and no warp outlives the others: its flip bit is
//     (R[r, c] & m1) ^ parity(slot_bits[r] & m0), with (c, m1, m0) = (-, 0,
//     0) for the baseline, (its column, 1, 0) for a single and (-, 0, its
//     slots) for a pattern; slot_bits[r] holds row r's bits at the first 32
//     slot columns, made once a lane. Slots past 32 (OSD-CS above order 32)
//     are read bit by bit, by pattern threads only.
//   - A row's two possible terms (its weight where the flip bit is 0 or 1,
//     +0.0 for the other, from s_r) are made once a lane, so a row step is
//     one read of the single's word (distinct banks for the distinct words
//     of a row while Wp <= 32, a broadcast for equal ones), two broadcasts,
//     a select and an addition.
//   - The "shared" variant stages the lane's rows (m*Wp words, 16 bytes a
//     load where aligned), the rows' terms and slot bits and the W slot
//     columns in shared memory; the "device" variant, for codes whose rows
//     do not fit (toric d=31 and up), reads the rows and terms from device
//     memory as they are and keeps only the slot bits in shared memory. The
//     wrapper chooses by (m, n, dtype) alone
//     (ldpc_tpu_torch/ops/osd_cuda.py::lane_bytes counts what shared_bytes
//     below counts, with W at its largest, n).
//   - A block reduction finds the first minimum; the lane's two decodings
//     are then written straight to device memory: zeros, the pivot rows'
//     bits, the winner's flipped columns, each step behind a __syncthreads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Variants, as the wrapper passes them
enum Variant { kVariantShared = 0, kVariantDevice = 1 };

struct SweepArgs {
  const uint32_t* words;      // (B, m, Wp): R's columns at bits 0..n-1, T s at bit n
  const int* col_of_row;      // (B, m), n on an unused row
  const uint8_t* used;        // (B, m) bool
  const long long* order;     // (B, n): the non-pivot columns first, least reliable first
  const void* weights;        // (n + 1) in the dtype, weights[n] = 0
  const uint32_t* pat_masks;  // (P, Wq): bit w of pattern p = slot w flipped
  int m, n, Wp, k, W, Wq, P, singles, B;
  uint8_t* osd0;              // (B, n)
  uint8_t* osdw;              // (B, n)
};

// A row's term of a candidate's score where its flip bit is 0 and where it is 1
template <typename T>
struct alignas(2 * sizeof(T)) Terms {
  T off, on;
};

__host__ __device__ inline size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of a lane: in the shared variant its rows (m*Wp words,
// padded to 16 bytes), the rows' terms (m pairs), their slot bits (m words)
// and the slot columns (W ints); in the device variant the slot bits alone
size_t shared_bytes(int variant, int m, int Wp, int W, size_t elem) {
  const size_t slot_bits = (size_t)m * sizeof(uint32_t);
  if (variant == kVariantDevice) return slot_bits;
  return round16((size_t)m * Wp * sizeof(uint32_t)) + (size_t)m * 2 * elem + slot_bits +
         (size_t)W * sizeof(int);
}

template <typename T>
__device__ inline bool better(T v, int i, T bv, int bi) {
  return i >= 0 && (bi < 0 || v < bv || (v == bv && i < bi));
}

// What a candidate flips, as the row loop reads it (see the header)
struct Candidate {
  int kind;      // 0 the baseline, 1 a single, 2 a pattern
  int col;       // a single's column
  uint32_t m1;   // 1 for a single
  uint32_t m0;   // a pattern's first 32 slots
  int p;         // a pattern's index in the table
};

// One lane's view of the export, its rows in shared memory (kShared) or in
// device memory
template <typename T, bool kShared>
struct Lane {
  int m, n, Wp, W, Wq, S;
  const uint32_t* pat_masks;
  const uint32_t* M;         // the lane's rows
  const Terms<T>* terms;     // shared: the rows' terms
  const uint32_t* slot_bits; // the rows' bits at the first 32 slot columns
  const int* slots;          // shared: the slot columns
  const int* g_col;
  const uint8_t* g_used;
  const long long* g_order;
  const T* w_pad;

  __device__ T row_weight(int r) const {
    return __ldg(w_pad + (__ldg(g_used + r) ? __ldg(g_col + r) : n));
  }
  __device__ int slot(int w) const { return kShared ? slots[w] : (int)__ldg(g_order + w); }
  __device__ uint32_t syndrome(const uint32_t* row) const { return (row[n >> 5] >> (n & 31)) & 1u; }

  __device__ Candidate candidate(int idx) const {
    if (idx == 0) return {0, 0, 0u, 0u, 0};
    if (idx <= S) return {1, (int)__ldg(g_order + idx - 1), 1u, 0u, 0};
    const int p = idx - 1 - S;
    return {2, 0, 0u, __ldg(pat_masks + (size_t)p * Wq), p};
  }

  // Bit 0: the candidate's flip bit in row r
  __device__ uint32_t flip(const Candidate& c, int r, const uint32_t* row) const {
    uint32_t f = ((row[c.col >> 5] >> (c.col & 31)) & c.m1) ^ (__popc(slot_bits[r] & c.m0) & 1u);
    if (Wq > 1 && c.kind == 2) {  // slots past the first 32
      const uint32_t* pm = pat_masks + (size_t)c.p * Wq;
      for (int q = 1; q < Wq; ++q) {
        for (uint32_t mm = __ldg(pm + q); mm; mm &= mm - 1) {
          const int s = slot(32 * q + __ffs(mm) - 1);
          f ^= (row[s >> 5] >> (s & 31)) & 1u;
        }
      }
    }
    return f & 1u;
  }

  __device__ T term(const Candidate& c, int r) const {
    const uint32_t* row = M + (size_t)r * Wp;
    const uint32_t f = flip(c, r, row);
    if (kShared) {
      const Terms<T> t = terms[r];
      return f ? t.on : t.off;
    }
    return (syndrome(row) ^ f) ? row_weight(r) : T(0);
  }

  __device__ T score(const Candidate& c) const {
    T acc = term(c, 0);
    for (int r = 1; r < m; ++r) acc = acc + term(c, r);
    if (c.kind == 1) return acc + __ldg(w_pad + c.col);
    if (c.kind == 2) {
      const uint32_t* pm = pat_masks + (size_t)c.p * Wq;
      for (int w = 0; w < W; ++w) {
        const bool on = (__ldg(pm + (w >> 5)) >> (w & 31)) & 1u;
        acc = acc + (on ? __ldg(w_pad + slot(w)) : T(0));
      }
    }
    return acc;
  }
};

template <typename T, bool kShared>
__global__ void __launch_bounds__(1024) osd_sweep_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red_v[32];
  __shared__ int red_i[32];
  __shared__ int winner;
  const int lane = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t lane_words = (size_t)a.m * a.Wp;
  const uint32_t* g_M = a.words + (size_t)lane * lane_words;
  const int* g_col = a.col_of_row + (size_t)lane * a.m;
  const uint8_t* g_used = a.used + (size_t)lane * a.m;
  const long long* g_order = a.order + (size_t)lane * a.n;
  const T* w_pad = static_cast<const T*>(a.weights);

  uint32_t* s_M = reinterpret_cast<uint32_t*>(smem);
  Terms<T>* s_terms = reinterpret_cast<Terms<T>*>(smem + round16(lane_words * sizeof(uint32_t)));
  uint32_t* s_bits = kShared ? reinterpret_cast<uint32_t*>(s_terms + a.m)
                             : reinterpret_cast<uint32_t*>(smem);
  int* s_slot = reinterpret_cast<int*>(s_bits + a.m);
  if (kShared) {
    if ((lane_words & 3) == 0 && (reinterpret_cast<uintptr_t>(g_M) & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(g_M);
      uint4* dst = reinterpret_cast<uint4*>(s_M);
#pragma unroll 4
      for (size_t i = t; i < lane_words / 4; i += nt) dst[i] = __ldg(src + i);
    } else {
      for (size_t i = t; i < lane_words; i += nt) s_M[i] = __ldg(g_M + i);
    }
    for (int w = t; w < a.W; w += nt) s_slot[w] = (int)__ldg(g_order + w);
    __syncthreads();
  }
  const Lane<T, kShared> L{a.m, a.n, a.Wp, a.W, a.Wq, a.singles ? a.k : 0, a.pat_masks,
                           kShared ? s_M : g_M, s_terms, s_bits, s_slot, g_col, g_used,
                           g_order, w_pad};
  // each row's bits at the first 32 slot columns and, staged, its two terms
  const int W32 = a.W < 32 ? a.W : 32;
  for (int r = t; r < a.m; r += nt) {
    const uint32_t* row = L.M + (size_t)r * a.Wp;
    uint32_t bits = 0;
    for (int w = 0; w < W32; ++w) {
      const int c = L.slot(w);
      bits |= ((row[c >> 5] >> (c & 31)) & 1u) << w;
    }
    s_bits[r] = bits;
    if (kShared) {
      const T wr = L.row_weight(r);
      s_terms[r] = L.syndrome(row) ? Terms<T>{wr, T(0)} : Terms<T>{T(0), wr};
    }
  }
  __syncthreads();

  // each thread's first minimum over its candidates, in ascending order
  const int C = 1 + L.S + a.P;
  T bv = T(0);
  int bi = -1;
  for (int idx = t; idx < C; idx += nt) {
    const T v = L.score(L.candidate(idx));
    if (better(v, idx, bv, bi)) {
      bv = v;
      bi = idx;
    }
  }
  // the block's first minimum
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = t >> 5, nwarps = (nt + 31) >> 5;
  if ((t & 31) == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (t == 0) {
    for (int i = 1; i < nwarps; ++i) {
      if (better(red_v[i], red_i[i], bv, bi)) {
        bv = red_v[i];
        bi = red_i[i];
      }
    }
    winner = bi;
  }

  // the decodings: zeros; the pivot rows' bits; the winner's flipped columns
  uint8_t* x0 = a.osd0 + (size_t)lane * a.n;
  uint8_t* xw = a.osdw + (size_t)lane * a.n;
  for (int c = t; c < a.n; c += nt) {
    x0[c] = 0;
    xw[c] = 0;
  }
  __syncthreads();
  const Candidate win = L.candidate(winner);
  for (int r = t; r < a.m; r += nt) {
    if (!__ldg(g_used + r)) continue;
    const uint32_t* row = L.M + (size_t)r * a.Wp;
    const uint32_t s = L.syndrome(row);
    const int c = __ldg(g_col + r);
    x0[c] = (uint8_t)s;
    xw[c] = (uint8_t)(s ^ L.flip(win, r, row));
  }
  __syncthreads();
  if (win.kind == 1 && t == 0) xw[win.col] = 1;
  if (win.kind == 2) {
    const uint32_t* pm = a.pat_masks + (size_t)win.p * a.Wq;
    for (int w = t; w < a.W; w += nt) {
      if ((__ldg(pm + (w >> 5)) >> (w & 31)) & 1u) xw[L.slot(w)] = 1;
    }
  }
}

template <typename T>
int launch(const SweepArgs& a, int variant, cudaStream_t stream) {
  // a thread a candidate, and at least four warps to stage the lane
  const int C = 1 + (a.singles ? a.k : 0) + a.P;
  int threads = ((C + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024) threads = 1024;
  const size_t smem = shared_bytes(variant, a.m, a.Wp, a.W, sizeof(T));
  const auto kernel = variant == kVariantDevice ? osd_sweep_kernel<T, false>
                                                : osd_sweep_kernel<T, true>;
  if (smem > 48 * 1024) {
    // above the default 48 KB only by opt-in; a code above the card's limit
    // fails here (the wrapper chooses the device variant for it)
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // cleared: not the next launch's error
      return (int)err;
    }
  }
  kernel<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The sweep over B lanes of K3's export, one block a lane: osd0 and osdw
// (B, n) uint8. `order` (B, n) int64 holds each lane's non-pivot columns
// first, least reliable first (k of them); `weights` (n + 1) float32, or
// float64 where f64; `pat_masks` (P, Wq) the pattern table over W slots,
// packed LSB-first; `singles` 1 for OSD-CS. `variant` 0 stages the lane in
// shared memory, 1 reads it from device memory. Returns cudaGetLastError()
// after the launch (0 on success), or the error of raising the block's
// shared-memory limit. Nothing synchronises.
int ldpc_osd_sweep(const void* words, const void* col_of_row, const void* used,
                   const void* order, const void* weights, const void* pat_masks, int m,
                   int n, int Wp, int k, int W, int Wq, int P, int singles, int f64, int B,
                   int variant, void* osd0, void* osdw, void* stream) {
  SweepArgs a;
  a.words = static_cast<const uint32_t*>(words);
  a.col_of_row = static_cast<const int*>(col_of_row);
  a.used = static_cast<const uint8_t*>(used);
  a.order = static_cast<const long long*>(order);
  a.weights = weights;
  a.pat_masks = static_cast<const uint32_t*>(pat_masks);
  a.m = m;
  a.n = n;
  a.Wp = Wp;
  a.k = k;
  a.W = W;
  a.Wq = Wq;
  a.P = P;
  a.singles = singles;
  a.B = B;
  a.osd0 = static_cast<uint8_t*>(osd0);
  a.osdw = static_cast<uint8_t*>(osdw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(a, variant, st) : launch<float>(a, variant, st);
}

}  // extern "C"
