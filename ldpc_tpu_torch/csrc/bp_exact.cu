// K8': float64 fold-exact parallel BP for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the XLA loop ldpc_tpu/ops/bp.py:251
// _make_parallel_decoder_exact, parallel BP that stores bit-to-check
// messages, which BpDecoder and BpOsdDecoder run in float64. It computes
// what its plain PyTorch version ldpc_tpu_torch/ops/bp_fold.py::
// bp_parallel_exact_reference computes, the reference's steps:
//   - min-sum: a check's message into slot k is the minimum |message| of
//     its other slots (absent ones counting 1e30; the exclusive minimum
//     with the first-occurrence argmin), signed by the parity of the
//     others' signs (v <= 0 counts negative) and the syndrome bit, scaled
//     by alpha (fixed, or 1 - 2^-it when the factor is 0);
//   - product-sum: exclusive prefix and suffix products of tanh(v/2) in
//     row order, then log((1+p)/(1-p)) signed by the syndrome bit (float64
//     keeps the saturation to inf: no clip);
//   - a bit's posterior is the channel LLR plus its c2v messages in slot
//     order (a left fold), and its message into slot k is the fold of the
//     slots before k plus the reverse fold of the slots after it, from the
//     last down (bp.hpp:277-318, 500-535);
//   - a lane converges when the parity of its hard decisions equals its
//     syndrome, tested after the bit pass, and freezes there.
// Every sum and product is taken by one thread in that order and the build
// uses -fmad=false, so min-sum is bit-identical to the plain version.
//
// What bounds it on the H100: the SM's instruction issue. A lane-iteration
// is a chain of passes (check pass -> bit pass -> syndrome test) over a
// few KB of state; at d=13 an f64 lane's messages are 4,992 bytes, most
// lanes stop after one or two iterations while the lanes BP fails run all
// max_iter (69% of the lane-iterations at the main-path call). The first
// design held 25 lanes an SM; measured on the card (PERF.md), raising that
// to 40 bought 3%, while each cut of the instructions a lane-iteration
// issues bought 5-26%. So the design spends registers and shared memory on
// fewer instructions, not on more resident lanes:
//   - One warp per lane, kLanes lanes a block (1, 2, 4 and 8 timed within
//     3% of each other; PERF.md). Warps are persistent: each
//     claims its next lane from a counter (atomicAdd) when its lane is
//     done, so a block's slots never wait for a slow lane of the block and
//     the grid is only as large as the card holds at once.
//   - The shared variant's block copies the graph's indices (chk_bits and
//     var_edges, slot-major) once into shared memory as 16-bit words: a
//     row's or a column's index is one shared load with 32-bit addressing
//     instead of a global load and 64-bit address arithmetic.
//   - A lane's shared state is its messages (m*dc f64, slot-major: the
//     threads of a warp, which own consecutive checks, touch consecutive
//     words) and one decision byte a bit. The syndrome bits of a thread's
//     checks live in a register (m <= 1024); the posteriors and decisions
//     go straight to the outputs from the bit pass.
//   - No prologue: iteration 1 reads a slot's message as llr0 of the row's
//     bit (a pad is never read), so nothing is initialised; no epilogue but
//     max_iter = 0, which writes llr0 and zero decisions.
//   - The syndrome test of iteration it rides on the check pass of
//     iteration it + 1, on the row indices it reads anyway; a lane that has
//     converged leaves the messages that pass wrote unread. Only after
//     max_iter does the test run alone.
//   - A check's thread reads its row once an iteration and keeps min1,
//     min2, the argmin and the sign bits in registers, straight-line over
//     CAP slots (a slot past the row reads slot 0 and counts for nothing;
//     a row above 32 slots takes a loop that reads it twice). A bit's
//     thread reads its dv c2v values once into registers (2 or kBitCap
//     slots; wider columns take a loop) and forms the left fold, the
//     partials and the reverse fold from them.
//   - 64 registers a thread (__launch_bounds__): 32 lanes resident an SM
//     at d=13; 48 registers held 40 lanes but cost 17% in instructions.
//   - No size cliff: a lane above kLaneBudget keeps its messages in a
//     lane-major scratch in device memory and its decisions in the output,
//     reading the graph through __ldg (same kernel, still one warp per
//     lane). ldpc_bp_exact_shared_state tells the wrapper which.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kBig = 1e30;  // absent slots' magnitude
constexpr int kLanes = 8;      // lanes (warps) a block
// A lane's state lives in shared memory up to this many bytes (K1''s budget)
constexpr size_t kLaneBudget = 24 * 1024;
// columns of up to this many slots keep their c2v values in registers
constexpr int kBitCap = 4;
// checks a thread owns whose syndrome bits fit its register (i = t + 32 r)
constexpr int kMaskChecks = 32 * 32;
// the shared variant keeps the graph's indices as 16-bit words
constexpr int kMaxIndex = 65535;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// A lane's pieces in shared memory: messages at 0, then one decision byte a
// bit; nothing in the device variant.
struct Layout {
  size_t hard, total;
};

__host__ __device__ inline Layout lane_layout(int m, int n, int dc, bool shared) {
  Layout L{};
  if (shared) {
    L.hard = align16((size_t)m * dc * sizeof(double));
    L.total = L.hard + align16((size_t)n);
  }
  return L;
}

// Bytes of a block's copy of the graph (shared variant): chk_bits, then
// var_edges, as 16-bit words.
__host__ __device__ inline size_t graph_bytes(int m, int n, int dc, int dv, bool shared) {
  return shared ? align16((size_t)dc * m * 2) + align16((size_t)dv * n * 2) : 0;
}

__host__ __device__ inline size_t block_bytes(int m, int n, int dc, int dv, bool shared) {
  return graph_bytes(m, n, dc, dv, shared) + (size_t)kLanes * lane_layout(m, n, dc, shared).total;
}

struct Args {
  const uint8_t* synd;     // (B, m) 0/1 syndromes
  const double* llr0;      // (n,) channel LLRs
  const int* chk_bits;     // (dc, m) slot-major, pad n
  const int* var_edges;    // (dv, n) slot-major edge ids slot*m + check, pad m*dc
  int m, n, dc, dv, B, max_iter;
  double ms_scaling;
  double* msg;             // device variant: (B, m*dc) lane-major scratch
  double* post;            // (B, n)
  uint8_t* dec;            // (B, n)
  bool* conv;              // (B,)
  int* iters;              // (B,)
  int* next;               // the next lane to claim, 0 at launch
  // optional (B, 5): clock64 cycles of the prologue, check passes, bit
  // passes, syndrome tests and epilogue of each lane
  long long* prof;
};

// The graph's indices as a lane reads them: the block's 16-bit copy in
// shared memory (shared variant) or the int32 arrays through __ldg.
template <bool kShared>
struct Graph {
  const uint16_t* cb;  // (dc, m)
  const uint16_t* ve;  // (dv, n)
  __device__ __forceinline__ int row_bit(const Args& a, int idx) const {
    if constexpr (kShared) return cb[idx];
    return __ldg(a.chk_bits + idx);
  }
  __device__ __forceinline__ int col_edge(const Args& a, int idx) const {
    if constexpr (kShared) return ve[idx];
    return __ldg(a.var_edges + idx);
  }
};

// One check pass: every check's c2v messages in place over its slots (CAP
// slots unrolled and straight-line, a slot past the row reading slot 0 and
// counting for nothing; CAP 0: any dc, the row read twice). kFirst
// (iteration 1) reads a slot's bit-to-check message as the channel LLR of
// its bit. kParity also tests the decisions of the bit pass before against
// the syndrome, on the row's bit indices the pass reads anyway, and returns
// whether this thread's checks all hold; when the lane has converged the
// messages this pass wrote are never read.
template <bool kMinSum, int CAP, bool kFirst, bool kParity, bool kShared>
__device__ __forceinline__ bool check_pass(const Args& a, const Graph<kShared>& g, int t,
                                           double alpha, double* msg, const uint8_t* syn,
                                           unsigned smask, const uint8_t* hard) {
  const int m = a.m, n = a.n, dc = a.dc;
  bool ok = true;
  for (int r = 0, i = t; i < m; ++r, i += 32) {
    const int s = m <= kMaskChecks ? (int)((smask >> r) & 1u) : (int)__ldg(syn + i);
    int par = s;
    if constexpr (kMinSum) {
      // one pass in slot order: the first-occurrence argmin and min1, and
      // min2 = min(1e30, the other slots), absent slots counting 1e30
      double min1 = kBig, min2 = kBig;
      int amin = 0;
      if constexpr (CAP > 0) {
        unsigned neg = 0;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          const bool in_row = k < dc;
          const int at = (in_row ? k : 0) * m + i;
          const int j = g.row_bit(a, at);
          const bool edge = in_row && j < n;
          double v = 0.0;
          if (kFirst) {
            if (edge) v = __ldg(a.llr0 + j);
          } else {
            v = msg[at];
          }
          if (kParity) {
            int h = 0;
            if (edge) h = hard[j];
            par ^= h;
          }
          const double mag = edge ? fabs(v) : kBig;
          neg |= (unsigned)(edge && v <= 0.0) << k;
          if (k == 0) {
            min1 = mag;
          } else {
            const bool below1 = in_row && mag < min1, below2 = in_row && mag < min2;
            min2 = below1 ? (min1 < min2 ? min1 : min2) : (below2 ? mag : min2);
            amin = below1 ? k : amin;
            min1 = below1 ? mag : min1;
          }
        }
        // alpha times min1 and min2, each rounded once; the sign flips the
        // top bit
        // (a row's pad slots are written too: nothing reads them)
        const double r1 = alpha * min1, r2 = alpha * min2;
        const int sp = s + __popc(neg);
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          const double v = k == amin ? r2 : r1;
          const int flip = (sp + (int)((neg >> k) & 1u)) & 1;
          const double out = __hiloint2double(__double2hiint(v) ^ (flip << 31), __double2loint(v));
          if (k < dc) msg[k * m + i] = out;
        }
      } else {
        int negs = 0;
        for (int k = 0; k < dc; ++k) {
          const int j = g.row_bit(a, k * m + i);
          double mag = kBig;
          if (j < n) {
            const double v = kFirst ? __ldg(a.llr0 + j) : msg[k * m + i];
            if (kParity) par ^= hard[j];
            mag = fabs(v);
            negs += v <= 0.0;
          }
          if (k == 0) {
            min1 = mag;
          } else if (mag < min1) {
            min2 = min1 < min2 ? min1 : min2;
            min1 = mag;
            amin = k;
          } else if (mag < min2) {
            min2 = mag;
          }
        }
        for (int k = 0; k < dc; ++k) {
          const int j = g.row_bit(a, k * m + i);
          if (j >= n) continue;
          const double x = kFirst ? __ldg(a.llr0 + j) : msg[k * m + i];
          const double v = alpha * (k == amin ? min2 : min1);
          msg[k * m + i] = ((s + negs + (x <= 0.0)) & 1) ? -v : v;
        }
      }
    } else {
      // exclusive products: suf[k] of the slots after k from the last
      // down, the prefix of the slots before k carried in order
      double th[CAP];
      unsigned on = 0;
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        th[k] = 1.0;
        if (k < dc) {
          const int j = g.row_bit(a, k * m + i);
          if (j < n) {
            const double v = kFirst ? __ldg(a.llr0 + j) : msg[k * m + i];
            if (kParity) par ^= hard[j];
            th[k] = tanh(v * 0.5);
            on |= 1u << k;
          }
        }
      }
      double suf[CAP];
      double acc = 1.0;
#pragma unroll
      for (int k = CAP - 1; k >= 0; --k) {
        suf[k] = acc;
        if (k < dc) acc = acc * th[k];
      }
      acc = 1.0;
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        if ((on >> k) & 1u) {
          const double p = acc * suf[k];
          const double mag = log((1.0 + p) / (1.0 - p));
          msg[k * m + i] = s ? -mag : mag;
        }
        if (k < dc) acc = acc * th[k];
      }
    }
    ok = ok && par == 0;
  }
  return ok;
}

// A bit's fold from its K slots' c2v values in registers (K >= dv): the
// posterior, returned, and its messages in place.
template <int K, bool kShared>
__device__ __forceinline__ double fold_bit(const Args& a, const Graph<kShared>& g, int j,
                                           double l0, double* msg) {
  const int n = a.n, dv = a.dv, E = a.m * a.dc;
  int e[K];
  double c[K], part[K];
  double l = l0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = k < dv ? g.col_edge(a, k * n + j) : E;
    if (e[k] < E) {
      c[k] = msg[e[k]];
      part[k] = l;  // channel + the slots before k, left fold
      l = l + c[k];
    }
  }
  double suf = 0.0;  // the slots after k, from the last down
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (e[k] < E) {
      msg[e[k]] = part[k] + suf;
      suf = suf + c[k];
    }
  }
  return l;
}

// One bit pass: each bit's posterior (to the output), its decision (to the
// output, and to the lane's decision bytes in the shared variant) and its
// bit-to-check messages in place over its edges.
template <bool kShared>
__device__ __forceinline__ void bit_pass(const Args& a, const Graph<kShared>& g, int t,
                                         double* msg, double* po, uint8_t* de, uint8_t* hard) {
  const int n = a.n, dv = a.dv, E = a.m * a.dc;
  for (int j = t; j < n; j += 32) {
    const double l0 = __ldg(a.llr0 + j);
    double l;
    if (dv <= 2) {
      l = fold_bit<2>(a, g, j, l0, msg);
    } else if (dv <= kBitCap) {
      l = fold_bit<kBitCap>(a, g, j, l0, msg);
    } else {
      l = l0;
      for (int k = 0; k < dv; ++k) {
        const int e = g.col_edge(a, k * n + j);
        if (e < E) l = l + msg[e];
      }
      // from the last slot down: slot k's partial folds the slots before
      // k, which are still c2v values when it is written
      double suf = 0.0;
      for (int k = dv - 1; k >= 0; --k) {
        const int e = g.col_edge(a, k * n + j);
        if (e >= E) continue;
        const double c = msg[e];
        double part = l0;
        for (int q = 0; q < k; ++q) {
          const int eq = g.col_edge(a, q * n + j);
          if (eq < E) part = part + msg[eq];
        }
        msg[e] = part + suf;
        suf = suf + c;
      }
    }
    po[j] = l;
    const uint8_t h = l <= 0.0;
    de[j] = h;
    if (kShared) hard[j] = h;
  }
}

// The syndrome test alone on the new decisions, in every thread (after the
// last iteration; before, the next check pass takes it).
template <bool kShared>
__device__ __forceinline__ bool syndrome_ok(const Args& a, const Graph<kShared>& g, int t,
                                            const uint8_t* syn, unsigned smask,
                                            const uint8_t* hard) {
  const int m = a.m, n = a.n, dc = a.dc;
  bool ok = true;
  for (int r = 0, i = t; i < m && ok; ++r, i += 32) {
    int par = m <= kMaskChecks ? (int)((smask >> r) & 1u) : (int)__ldg(syn + i);
    for (int k = 0; k < dc; ++k) {
      const int j = g.row_bit(a, k * m + i);
      if (j < n) par ^= hard[j];
    }
    ok = par == 0;
  }
  return __all_sync(kFull, ok);
}

// The min-sum factor of iteration it: fixed, or 1 - 2^-it when it is 0.
template <bool kMinSum>
__device__ __forceinline__ double alpha_of(const Args& a, int it) {
  return (kMinSum && a.ms_scaling == 0.0) ? 1.0 - ldexp(1.0, -it) : a.ms_scaling;
}

// Adds the cycles since t0 to acc and restarts t0.
__device__ __forceinline__ void lap(long long& acc, long long& t0) {
  const long long t1 = clock64();
  acc += t1 - t0;
  t0 = t1;
}

__host__ __device__ constexpr int min_blocks(bool min_sum, int cap) {
  // 64 registers a thread (4 blocks of eight lanes, 16 of two); product-sum
  // keeps 2*CAP doubles of a row in registers
  return (min_sum || cap <= 8) ? 4 : (cap <= 16 ? 2 : 1);
}

template <bool kMinSum, int CAP, bool kShared>
__global__ void __launch_bounds__(32 * kLanes, min_blocks(kMinSum, CAP))
    exact_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int m = a.m, n = a.n, dc = a.dc, dv = a.dv;
  Graph<kShared> g{};
  size_t off = 0;
  if constexpr (kShared) {
    // the block's copy of the graph's indices, made once: its warps then
    // take lanes until the batch is done
    uint16_t* cb = reinterpret_cast<uint16_t*>(smem);
    uint16_t* ve = reinterpret_cast<uint16_t*>(smem + align16((size_t)dc * m * 2));
    for (int x = threadIdx.x; x < dc * m; x += blockDim.x) cb[x] = (uint16_t)__ldg(a.chk_bits + x);
    for (int x = threadIdx.x; x < dv * n; x += blockDim.x) {
      ve[x] = (uint16_t)__ldg(a.var_edges + x);
    }
    __syncthreads();
    g.cb = cb;
    g.ve = ve;
    off = graph_bytes(m, n, dc, dv, true);
  }
  const Layout L = lane_layout(m, n, dc, kShared);
  unsigned char* base = smem + off + (size_t)w * L.total;
  const bool profiled = a.prof != nullptr;
  for (;;) {
    long long t0 = profiled ? clock64() : 0;
    int b = 0;
    if (t == 0) b = atomicAdd(a.next, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= a.B) break;
    double* msg = kShared ? reinterpret_cast<double*>(base) : a.msg + (size_t)b * m * dc;
    double* po = a.post + (size_t)b * n;
    uint8_t* de = a.dec + (size_t)b * n;
    uint8_t* hard = kShared ? base + L.hard : de;
    const uint8_t* syn = a.synd + (size_t)b * m;
    // the syndrome bits of this thread's checks i = t + 32 r, bit r
    unsigned smask = 0;
    if (m <= kMaskChecks) {
      for (int r = 0, i = t; i < m; ++r, i += 32) smask |= (unsigned)__ldg(syn + i) << r;
    }
    long long cycles[5] = {0, 0, 0, 0, 0};
    if (profiled) lap(cycles[0], t0);
    // iteration it: its check pass (from iteration 2 on with the syndrome
    // test of iteration it - 1), then its bit pass
    bool converged = false;
    int it = 0;
    if (a.max_iter > 0) {
      it = 1;
      check_pass<kMinSum, CAP, true, false, kShared>(a, g, t, alpha_of<kMinSum>(a, 1), msg, syn,
                                                     smask, hard);
      for (;;) {
        __syncwarp();
        if (profiled) lap(cycles[1], t0);
        bit_pass<kShared>(a, g, t, msg, po, de, hard);
        __syncwarp();
        if (profiled) lap(cycles[2], t0);
        if (it == a.max_iter) {
          converged = syndrome_ok<kShared>(a, g, t, syn, smask, hard);
          if (profiled) lap(cycles[3], t0);
          break;
        }
        const bool ok = check_pass<kMinSum, CAP, false, true, kShared>(
            a, g, t, alpha_of<kMinSum>(a, it + 1), msg, syn, smask, hard);
        converged = __all_sync(kFull, ok);
        if (converged) {
          if (profiled) lap(cycles[1], t0);
          break;
        }
        ++it;
      }
    }
    if (it == 0) {  // max_iter 0: the channel LLRs and no decisions
      for (int j = t; j < n; j += 32) {
        po[j] = __ldg(a.llr0 + j);
        de[j] = 0;
      }
    }
    if (t == 0) {
      a.conv[b] = converged;
      a.iters[b] = it;
      if (profiled) {
        long long* out = a.prof + (size_t)b * 5;
        cycles[4] = clock64() - t0;
        for (int k = 0; k < 5; ++k) out[k] = cycles[k];
      }
    }
    __syncwarp();  // the lane's shared state is spent before the next claim
  }
}

// The kernel's grid for a launch shape: blocks resident on the card at once
// (the occupancy of this block size and shared memory times the SMs),
// found once per shape, with the attributes the launch needs set then.
struct Grid {
  size_t smem = ~(size_t)0;
  int device = -1, blocks = 0;
};

template <typename K>
cudaError_t set_up(K kernel, size_t smem, int* per_sm) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 32 * kLanes, smem);
  }
  if (err == cudaSuccess && *per_sm == 0) err = cudaErrorLaunchOutOfResources;
  if (err != cudaSuccess) cudaGetLastError();  // cleared: not the next launch's error
  return err;
}

template <bool kMinSum, int CAP, bool kShared>
int launch(const Args& a, cudaStream_t stream) {
  static Grid grid;  // one per instantiation
  auto kernel = exact_kernel<kMinSum, CAP, kShared>;
  const size_t smem = block_bytes(a.m, a.n, a.dc, a.dv, kShared);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (grid.smem != smem || grid.device != device) {
    int per_sm = 0, sms = 0;
    err = set_up(kernel, smem, &per_sm);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return (int)err;
    grid = Grid{smem, device, per_sm * sms};
  }
  const int needed = (a.B + kLanes - 1) / kLanes;
  kernel<<<needed < grid.blocks ? needed : grid.blocks, 32 * kLanes, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Calls f.run<kMinSum, CAP>() for a code's row width: min-sum CAP 4-32 or
// the loop (0), product-sum CAP 4-32; -1 for a product-sum row above 32.
template <typename F>
int by_width(int dc, int min_sum, const F& f) {
  if (dc <= 4) return min_sum ? f.template run<true, 4>() : f.template run<false, 4>();
  if (dc <= 8) return min_sum ? f.template run<true, 8>() : f.template run<false, 8>();
  if (dc <= 16) return min_sum ? f.template run<true, 16>() : f.template run<false, 16>();
  if (dc <= 32) return min_sum ? f.template run<true, 32>() : f.template run<false, 32>();
  return min_sum ? f.template run<true, 0>() : -1;
}

struct LaunchOp {
  const Args& a;
  int shared;
  cudaStream_t st;
  template <bool kMinSum, int CAP>
  int run() const {
    return shared ? launch<kMinSum, CAP, true>(a, st) : launch<kMinSum, CAP, false>(a, st);
  }
};

// Blocks resident on an SM (into *per_sm).
struct OccupancyOp {
  int shared;
  size_t smem;
  int* per_sm;
  template <bool kMinSum, int CAP>
  int run() const {
    return shared ? (int)set_up(exact_kernel<kMinSum, CAP, true>, smem, per_sm)
                  : (int)set_up(exact_kernel<kMinSum, CAP, false>, smem, per_sm);
  }
};

}  // namespace

extern "C" {

// 1 when a K8' lane of an (m, n, dc) code fits kLaneBudget (and the graph's
// indices 16 bits), so the shared-memory variant is the default; 0 for the
// device-memory variant.
int ldpc_bp_exact_shared_state(int m, int n, int dc) {
  return lane_layout(m, n, dc, true).total <= kLaneBudget && n <= kMaxIndex &&
         (long long)m * dc <= kMaxIndex;
}

// Bytes of shared memory a K8' lane of an (m, n, dc) code takes (the
// shared variant's block adds its copy of the graph's indices).
int ldpc_bp_exact_lane_bytes(int m, int n, int dc) {
  return (int)lane_layout(m, n, dc, true).total;
}

// K8' lanes resident on one SM for a code (the occupancy its registers and
// shared memory allow), or -1 on an error.
int ldpc_bp_exact_resident_lanes(int m, int n, int dc, int dv, int min_sum, int shared) {
  int per_sm = 0;
  const size_t smem = block_bytes(m, n, dc, dv, shared != 0);
  if (by_width(dc, min_sum, OccupancyOp{shared, smem, &per_sm}) != 0) return -1;
  return per_sm * kLanes;
}

// K8'. chk_bits_t (dc, m) and var_edges_t (dv, n) are the slot-major views
// K1' takes; product-sum needs dc <= 32 (the caller checks), the shared
// variant n and m*dc <= 65535. The device variant (shared == 0) reads msg (B, m*dc). next: one int32, 0 at
// launch (the lanes' claim counter). prof: null, or (B, 5) int64. Returns
// cudaGetLastError() after the launch (0 on success) or the error of
// setting the kernel up. Nothing synchronises.
int ldpc_bp_parallel_exact(const void* synd, const void* llr0, const void* chk_bits_t,
                           const void* var_edges_t, int m, int n, int dc, int dv, int B,
                           int max_iter, int min_sum, double ms_scaling, int shared, void* msg, void* post, void* dec, void* conv, void* iters, void* next,
                           void* prof, void* stream) {
  if (shared && (n > kMaxIndex || (long long)m * dc > kMaxIndex)) return (int)cudaErrorInvalidValue;
  Args a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.llr0 = static_cast<const double*>(llr0);
  a.chk_bits = static_cast<const int*>(chk_bits_t);
  a.var_edges = static_cast<const int*>(var_edges_t);
  a.m = m;
  a.n = n;
  a.dc = dc;
  a.dv = dv;
  a.B = B;
  a.max_iter = max_iter;
  a.ms_scaling = ms_scaling;
  a.msg = static_cast<double*>(msg);
  a.post = static_cast<double*>(post);
  a.dec = static_cast<uint8_t*>(dec);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  a.next = static_cast<int*>(next);
  a.prof = static_cast<long long*>(prof);
  auto st = static_cast<cudaStream_t>(stream);
  const int rc = by_width(dc, min_sum, LaunchOp{a, shared, st});
  return rc < 0 ? (int)cudaErrorInvalidValue : rc;
}

}  // extern "C"
