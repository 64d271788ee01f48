// K9': batched MBP (memory belief propagation) over GF(4) for Hopper (sm_90a).
//
// Replaces the XLA loop ldpc_tpu/ops/mbp.py::make_mbp_decoder (a
// while_loop over iterations around a fori_loop over the n qubits, vmapped
// over the batch; no pallas_call). It computes what its plain PyTorch
// version ldpc_tpu_torch/ops/mbp.py::mbp_reference computes, which is that
// loop's function (see the module's notes for the update rules).
//
// What bounds it on the H100: neither bytes nor operations. The sweep is a
// chain of dependent steps, qubit after qubit in index order, each reading
// the messages its predecessors wrote; the per-edge work is transcendental
// (three exp and one log an edge, one tanh more for product-sum), done in
// float64 at the card's float64 rate. The compulsory traffic is the
// syndromes in and the (B, 3, n) posteriors and (B, n) decisions out. What
// holds a lane back is the latency of its chain and of its state's
// scattered reads, so the card wants many lanes in flight, each warp doing
// only work its lane needs, and each lane's state close to the SM.
//
// What the design does about it:
//   - Level scheduling. Qubits that share no stabilizer commute in the
//     sweep (qubit j reads only its stabilizers' rows and writes only its
//     own edges), so a warp takes a whole level of the index order at a
//     time (the host's ops/bp_fold.py::serial_levels, once per decoder):
//     d=13's 313 dependent qubit steps become one step a level.
//   - One cached value an edge. An edge's lam is a pure function of its
//     qubit->stabilizer message and its Pauli, recomputed only when its
//     qubit writes that edge: the kernel keeps lam (min-sum) or tanh(lam/2)
//     (product-sum) an edge and never stores the messages, which nothing
//     reads again. The XLA loop recomputes dv*dc lams a qubit; this kernel
//     computes dv.
//   - Persistent warps that claim lanes. The grid is as many blocks as the
//     card holds at once (the occupancy API), and no more than the lanes
//     need; lane 0 of a warp claims the next lane from a counter the
//     wrapper zeroes (atomicAdd) and the warp decodes it, then claims the
//     next, until the batch is spent. A lane that converges early frees its
//     warp for the next lane at once, not when the slowest lane of its
//     block is done. The registers are capped (__launch_bounds__) so that
//     kMinBlocks blocks of kWarps warps fit an SM: 32 warps.
//   - Scratch a warp, not a lane. A warp's cache (m rows of dc values,
//     each row padded to 16 bytes; 9,984 bytes at d=13 in float64) is a
//     row of a (grid warps, m * row stride) device scratch, rewritten with
//     the initial values at each claim: the scratch is sized by the warps
//     in flight (42 MB at d=13 in float64, within the 50 MB L2), not by
//     the batch. Pass A reads a cache row 16 bytes at a time.
//   - A warp's slice: the level's messages and its qubits' posteriors, the
//     lane's decisions and its syndrome; the decisions go to the output
//     when the lane is done, the posteriors each time a qubit updates. The
//     slice grows with the code (1,920 bytes at d=13 in float64, 7,184 at
//     toric d=31, 20,960 at toric d=60) and lives in shared memory, so the
//     warps an SM fall with the code's size (32 at d=13, 24 at toric d=31
//     in float64, 8 at d=60): measured, that is faster there than 32 warps
//     with the slices in device memory, as fewer lanes with larger state
//     share the SM's L1 and the L2 better. Where a block of kWarps slices
//     does not fit a block's shared memory (a slice above 29 KB on the
//     H100: toric codes from d=75 in float64 and d=80 in float32, or wide
//     levels), the slices live in a second device scratch, a slice a warp
//     of the grid, and the registers alone set the residency; an instance
//     of the kernel for each place.
//   - Real pairs only. The host lists each level's real (qubit, slot)
//     pairs once (ops/mbp.py::gf4_to_torch: qubit-major, in slot order,
//     each with its stabilizer, own slot, level position, Pauli and row
//     degree), so no thread walks a pad slot or divides by a runtime dv.
//   - Three passes a level, a __syncwarp after each: pass A, a thread a
//     pair, forms the stabilizer->qubit message from its row's cached
//     values (slot order, its own slot excluded); pass B1, a thread a
//     qubit, sums its messages in slot order into its posterior, once a
//     qubit, and writes the posterior and decision; pass B2, a thread a
//     pair, forms the pair's new edge value from its qubit's posterior and
//     caches it. No two pairs of a level touch one row's entries that
//     another pair writes.
//   - Every sum, product and quotient is rounded once where the plain
//     version rounds it (__d*_rn / __f*_rn intrinsics, -fmad=false), and a
//     qubit's pad slots add their term (0 * 1/alpha) * 0 after its real
//     slots as the plain version's sum does (+0 unless 1/alpha is inf or
//     NaN). exp, log and tanh are CUDA's, the ones torch's CUDA kernels
//     call, so on the card the plain version and the kernel agree bit for
//     bit where their libraries agree; the comparison states its tolerance.
//   - Templated on float64, the decoder's default, and float32.
//
// Measured on the H100 (PERF.md): the state a float64 lane keeps hot is
// about 10 KB and an SM's L1 and shared memory together 256 KB, so 32
// lanes in flight spill part of it to L2; at 24 warps an SM float64 ran
// faster, float32 min-sum the same and float32 product-sum slower. Reading
// the cache through L2 only (ld.global.cg), two pairs a thread in passes A
// and B2, and an initial cache computed once a block and copied at each
// claim were slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;      // warps (lanes in flight) a block
constexpr int kMinBlocks = 4;  // blocks an SM the registers must allow

__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }
__device__ __forceinline__ float tanh_of(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_of(double x) { return tanh(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

template <typename T>
struct Args {
  const uint8_t* synd;      // (B, m) 0/1
  const T* chan;            // (3, n) channel LLRs
  const T* inv_alpha;       // (3, n)
  const int* chk_bits;      // (m, dc), pad n
  const uint8_t* chk_val;   // (m, dc), pad 0
  const int* lv_bits;       // (n,) qubits level by level
  const int* lv_ptr;        // (levels + 1,) into lv_bits
  const int* pair_ptr;      // (n + 1,) first real pair of each level position
  const int4* pairs;        // (edges,) stabilizer, own slot, level position,
                            // Pauli + 4 * row degree
  int levels, max_pairs, max_qubits;
  int m, n, dc, dv, B, max_iter;
  T beta, gamma;
  int* next;                // the lanes' claim counter, 0 at launch
  T* cache;                 // (grid warps, m * row stride) scratch
  unsigned char* slices;    // (grid warps, slice) scratch, unless in shared memory
  int slice;                // bytes of a warp's slice
  T* llr;                   // (B, 3, n) posteriors
  uint8_t* dec;             // (B, n) GF(4) decisions
  bool* conv;               // (B,)
  int* iters;               // (B,)
};

// A row of a warp's cache takes dc values rounded up to 16 bytes, so that
// pass A reads it 16 bytes at a time.
__host__ __device__ inline int row_stride(int dc, int elem) {
  const int per16 = 16 / elem;
  return (dc + per16 - 1) / per16 * per16;
}

// 16 bytes of a row of the cache (16-byte aligned) into registers.
__device__ __forceinline__ void load_vec(const double* p, double* v) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Bytes of the values of a warp's shared slice: a level's messages, then
// its qubits' posteriors (three a qubit).
__host__ __device__ inline int value_bytes(int max_pairs, int max_qubits, int elem) {
  return align16((max_pairs + 3 * max_qubits) * elem);
}

// Bytes of a warp's shared slice: the values, then the lane's decisions
// (n bytes) and syndrome (m bytes).
__host__ __device__ inline int warp_bytes(int max_pairs, int max_qubits, int m, int n, int elem) {
  return value_bytes(max_pairs, max_qubits, elem) + align16(n) + align16(m);
}

// The cached value of an edge whose message is (q0, q1, q2) and whose
// Pauli is val in 1..3: lam = log(1e-12 + (1 + e^-q[val]) / (sum of the
// other two e^-q)), or tanh(lam/2) for product-sum.
template <typename T, bool kMinSum>
__device__ __forceinline__ T edge_value(T q0, T q1, T q2, int val) {
  const T e0 = exp_of(-q0), e1 = exp_of(-q1), e2 = exp_of(-q2);
  const T ea = val == 1 ? e0 : (val == 2 ? e1 : e2);
  const T den = val == 1 ? add_rn(e1, e2) : (val == 2 ? add_rn(e0, e2) : add_rn(e0, e1));
  const T lam = log_of(add_rn(T(1e-12), div_rn(add_rn(ea, T(1)), den)));
  if constexpr (kMinSum) {
    return lam;
  } else {
    return tanh_of(mul_rn(lam, T(0.5)));
  }
}

// Pass A for the pair p: its stabilizer->qubit message from the other
// cached values of its stabilizer's row, in slot order.
template <typename T, bool kMinSum>
__device__ __forceinline__ T pair_message(const Args<T>& a, const T* cache, const uint8_t* syn,
                                          int stride, int p, T lo, T hi) {
  constexpr int kVec = 16 / sizeof(T);  // values a 16-byte load brings
  const int4 r = __ldg(a.pairs + p);
  const int own = r.y, deg = r.w >> 2;
  const T* row = cache + r.x * stride;
  const int s = syn[r.x];
  if constexpr (kMinSum) {
    T mn = T(1e30);
    int negs = 0;
    for (int v = 0; v < deg; v += kVec) {
      T vals[kVec];
      load_vec(row + v, vals);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int g = v + u;
        if (g >= deg || g == own) continue;
        const T lam = vals[u];
        const T x = abs_of(lam);
        mn = (mn != mn || x >= mn) ? mn : x;  // a NaN propagates
        negs += lam <= T(0);
      }
    }
    const T mag = mul_rn(a.gamma, mn);
    return ((s + negs) & 1) ? -mag : mag;
  } else {
    T prod = T(1);
    for (int v = 0; v < deg; v += kVec) {
      T vals[kVec];
      load_vec(row + v, vals);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int g = v + u;
        if (g >= deg || g == own) continue;
        prod = mul_rn(prod, vals[u]);
      }
    }
    prod = prod < lo ? lo : prod;  // a NaN stays
    prod = prod > hi ? hi : prod;
    const T mag = log_of(div_rn(add_rn(T(1), prod), sub_rn(T(1), prod)));
    return s ? -mag : mag;
  }
}

// Pass B2 for a pair r whose qubit's posterior is sp[0..2] and whose
// message is mv: the pair's new edge value.
template <typename T, bool kMinSum>
__device__ __forceinline__ T pair_edge_value(const int4 r, const T* sp, T mv) {
  const int val = r.w & 3;
  const T n0 = sub_rn(sp[0], val == 1 ? T(0) : mv);
  const T n1 = sub_rn(sp[1], val == 2 ? T(0) : mv);
  const T n2 = sub_rn(sp[2], val == 3 ? T(0) : mv);
  return edge_value<T, kMinSum>(n0, n1, n2, val);
}

// kShared: the warps' slices are in shared memory (a.slices unused), else
// in a.slices; an instance each, so that each reaches its slice by its own
// address space.
template <typename T, bool kMinSum, bool kShared>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) mbp_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int m = a.m, n = a.n, dc = a.dc, dv = a.dv;
  const int stride = row_stride(dc, sizeof(T));
  // this warp's slice (messages, posteriors, decisions, syndrome) and its
  // row of the cache scratch
  const size_t gw = (size_t)blockIdx.x * kWarps + w;
  unsigned char* mine = kShared ? smem + (size_t)w * a.slice : a.slices + gw * a.slice;
  T* smsg = reinterpret_cast<T*>(mine);
  T* spost = smsg + a.max_pairs;
  uint8_t* dec = mine + value_bytes(a.max_pairs, a.max_qubits, sizeof(T));
  uint8_t* syn = dec + align16(n);
  T* cache = a.cache + gw * m * stride;
  const T lo = sub_rn(T(1e-8), T(1)), hi = sub_rn(T(1), T(1e-8));

  for (;;) {
    int b = 0;
    if (t == 0) b = atomicAdd(a.next, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= a.B) break;
    T* llr = a.llr + (size_t)b * 3 * n;

    // the lane's syndrome and zero decisions into shared memory; each real
    // edge's initial message into the cache: its qubit's channel LLR, 0 on
    // the agreeing Pauli (pad entries are never read)
    for (int i = t; i < m; i += 32) syn[i] = a.synd[(size_t)b * m + i];
    for (int j = t; j < n; j += 32) dec[j] = 0;
    if (a.max_iter > 0) {
      for (int e = t; e < m * dc; e += 32) {
        const int j = __ldg(a.chk_bits + e);
        if (j < n) {
          const int val = __ldg(a.chk_val + e);
          const T q0 = val == 1 ? T(0) : __ldg(a.chan + j);
          const T q1 = val == 2 ? T(0) : __ldg(a.chan + n + j);
          const T q2 = val == 3 ? T(0) : __ldg(a.chan + 2 * n + j);
          cache[e / dc * stride + e % dc] = edge_value<T, kMinSum>(q0, q1, q2, val);
        }
      }
    }
    __syncwarp();

    bool converged = false;
    int it = 0;
    while (it < a.max_iter) {
      ++it;
      for (int l = 0; l < a.levels; ++l) {
        const int q0 = __ldg(a.lv_ptr + l), q1 = __ldg(a.lv_ptr + l + 1);
        const int p0 = __ldg(a.pair_ptr + q0), p1 = __ldg(a.pair_ptr + q1);

        // ---- pass A: each pair's stabilizer->qubit message -----------------
        for (int p = p0 + t; p < p1; p += 32) {
          smsg[p - p0] = pair_message<T, kMinSum>(a, cache, syn, stride, p, lo, hi);
        }
        __syncwarp();

        // ---- pass B1: each qubit's posterior and decision, once ------------
        for (int i = q0 + t; i < q1; i += 32) {
          const int j = __ldg(a.lv_bits + i);
          const int f = __ldg(a.pair_ptr + i), cnt = __ldg(a.pair_ptr + i + 1) - f;
          const T ia0 = __ldg(a.inv_alpha + j), ia1 = __ldg(a.inv_alpha + n + j),
                  ia2 = __ldg(a.inv_alpha + 2 * n + j);
          T acc0 = T(0), acc1 = T(0), acc2 = T(0);
          for (int k = 0; k < cnt; ++k) {
            const T mv = smsg[f - p0 + k];
            const int val = __ldg(&a.pairs[f + k].w) & 3;
            acc0 = add_rn(acc0, mul_rn(mv, val == 1 ? a.beta : ia0));
            acc1 = add_rn(acc1, mul_rn(mv, val == 2 ? a.beta : ia1));
            acc2 = add_rn(acc2, mul_rn(mv, val == 3 ? a.beta : ia2));
          }
          if (cnt < dv) {  // the pad slots' term, the same for each
            acc0 = add_rn(acc0, mul_rn(mul_rn(T(0), ia0), T(0)));
            acc1 = add_rn(acc1, mul_rn(mul_rn(T(0), ia1), T(0)));
            acc2 = add_rn(acc2, mul_rn(mul_rn(T(0), ia2), T(0)));
          }
          const T l0 = add_rn(__ldg(a.chan + j), acc0);
          const T l1 = add_rn(__ldg(a.chan + n + j), acc1);
          const T l2 = add_rn(__ldg(a.chan + 2 * n + j), acc2);
          llr[j] = l0;
          llr[n + j] = l1;
          llr[2 * n + j] = l2;
          T* sp = spost + 3 * (i - q0);
          sp[0] = l0;
          sp[1] = l1;
          sp[2] = l2;
          // the first least Pauli (a NaN counts least), identity when all
          // three are positive
          int best = 0;
          T bv = l0;
          if (bv == bv && (l1 != l1 || l1 < bv)) { best = 1; bv = l1; }
          if (bv == bv && (l2 != l2 || l2 < bv)) { best = 2; bv = l2; }
          dec[j] = (l0 > T(0) && l1 > T(0) && l2 > T(0)) ? 0 : (uint8_t)(best + 1);
        }
        __syncwarp();

        // ---- pass B2: each pair's new edge value, cached -------------------
        for (int p = p0 + t; p < p1; p += 32) {
          const int4 r = __ldg(a.pairs + p);
          cache[r.x * stride + r.y] =
              pair_edge_value<T, kMinSum>(r, spost + 3 * (r.z - q0), smsg[p - p0]);
        }
        __syncwarp();
      }

      // ---- the decisions' Pauli syndrome against the syndrome -------------
      bool ok = true;
      for (int i = t; i < m && ok; i += 32) {
        int par = syn[i];
        for (int g = 0; g < dc; ++g) {
          const int j = __ldg(a.chk_bits + i * dc + g);
          if (j >= n) break;  // a row's pads come last
          const int d = dec[j];
          par ^= (d != 0 && d != __ldg(a.chk_val + i * dc + g)) ? 1 : 0;
        }
        ok = (par == 0);
      }
      converged = __all_sync(kFull, ok);
      if (converged) break;
    }

    for (int j = t; j < n; j += 32) a.dec[(size_t)b * n + j] = dec[j];
    if (t == 0) {
      a.conv[b] = converged;
      a.iters[b] = it;
    }
    __syncwarp();  // the slice is the next lane's
  }
}

// The launch shape of an instance for a code: blocks resident on an SM
// and on the card, whether the warps' slices are in shared memory,
// registers a thread and local (spill) bytes; found once per (instance,
// slice bytes, device), with the attributes the launch needs set then. The
// slices are in shared memory wherever a block of kWarps of them fits.
struct Shape {
  int per_sm = 0, sms = 0, regs = 0, local = 0;
  bool in_shared = false;
  size_t smem = 0;  // dynamic shared bytes a block
};

struct ShapeCache {
  int device = -1, slice_bytes = -1;
  cudaError_t err = cudaSuccess;
  Shape s;
};

template <typename T, bool kMinSum>
cudaError_t shape_of(int slice_bytes, Shape* out) {
  static ShapeCache cached;  // one per instantiation
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (cached.device != device || cached.slice_bytes != slice_bytes) {
    auto in_shared = mbp_kernel<T, kMinSum, true>;
    auto in_device = mbp_kernel<T, kMinSum, false>;
    Shape s;
    int optin = 0;
    const size_t smem = (size_t)kWarps * slice_bytes;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    s.in_shared = smem <= (size_t)optin;
    if (err == cudaSuccess && s.in_shared) {
      s.smem = smem;
      err = cudaFuncSetAttribute(in_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, in_shared, 32 * kWarps,
                                                            smem);
      }
    } else if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, in_device, 32 * kWarps, 0);
    }
    if (err == cudaSuccess && s.per_sm == 0) err = cudaErrorLaunchOutOfResources;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, device);
    }
    cudaFuncAttributes attr;
    if (err == cudaSuccess) {
      err = cudaFuncGetAttributes(&attr, s.in_shared ? (const void*)in_shared
                                                      : (const void*)in_device);
    }
    if (err == cudaSuccess) {
      s.regs = attr.numRegs;
      s.local = (int)attr.localSizeBytes;
    }
    if (err != cudaSuccess) cudaGetLastError();  // cleared: not the next launch's error
    cached = ShapeCache{device, slice_bytes, err, s};
  }
  *out = cached.s;
  return cached.err;
}

int slice_of(int max_pairs, int max_qubits, int m, int n, int f64) {
  return warp_bytes(max_pairs, max_qubits, m, n, f64 ? sizeof(double) : sizeof(float));
}

cudaError_t shape_for(int slice, int min_sum, int f64, Shape* s) {
  if (f64) return min_sum ? shape_of<double, true>(slice, s) : shape_of<double, false>(slice, s);
  return min_sum ? shape_of<float, true>(slice, s) : shape_of<float, false>(slice, s);
}

// Blocks a launch of B lanes takes: those the card holds at once, no more
// than the lanes need.
int grid_blocks(const Shape& s, int B) {
  const int needed = (B + kWarps - 1) / kWarps;
  const int resident = s.per_sm * s.sms;
  return needed < resident ? needed : resident;
}

template <typename T, bool kMinSum>
void launch(const Args<T>& a, const Shape& s, int blocks, cudaStream_t st) {
  if (s.in_shared) {
    mbp_kernel<T, kMinSum, true><<<blocks, 32 * kWarps, s.smem, st>>>(a);
  } else {
    mbp_kernel<T, kMinSum, false><<<blocks, 32 * kWarps, 0, st>>>(a);
  }
}

template <typename T>
int run(const void* synd, const void* chan, const void* inv_alpha, const void* chk_bits,
        const void* chk_val, const void* lv_bits, const void* lv_ptr, const void* pair_ptr,
        const void* pairs, int levels, int max_pairs, int max_qubits, int m, int n, int dc,
        int dv, int B, int max_iter, int min_sum, double beta, double gamma, int blocks,
        void* next, void* cache, void* slices, void* llr, void* dec, void* conv, void* iters,
        cudaStream_t st) {
  Shape s;
  const int slice = slice_of(max_pairs, max_qubits, m, n, sizeof(T) == 8);
  cudaError_t err = shape_for(slice, min_sum, sizeof(T) == 8, &s);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1 || blocks > s.per_sm * s.sms || (!s.in_shared && !slices)) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.chan = static_cast<const T*>(chan);
  a.inv_alpha = static_cast<const T*>(inv_alpha);
  a.chk_bits = static_cast<const int*>(chk_bits);
  a.chk_val = static_cast<const uint8_t*>(chk_val);
  a.lv_bits = static_cast<const int*>(lv_bits);
  a.lv_ptr = static_cast<const int*>(lv_ptr);
  a.pair_ptr = static_cast<const int*>(pair_ptr);
  a.pairs = static_cast<const int4*>(pairs);
  a.levels = levels;
  a.max_pairs = max_pairs;
  a.max_qubits = max_qubits;
  a.m = m;
  a.n = n;
  a.dc = dc;
  a.dv = dv;
  a.B = B;
  a.max_iter = max_iter;
  a.beta = static_cast<T>(beta);
  a.gamma = static_cast<T>(gamma);
  a.next = static_cast<int*>(next);
  a.cache = static_cast<T*>(cache);
  a.slices = static_cast<unsigned char*>(slices);
  a.slice = slice;
  a.llr = static_cast<T*>(llr);
  a.dec = static_cast<uint8_t*>(dec);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  if (min_sum) {
    launch<T, true>(a, s, blocks, st);
  } else {
    launch<T, false>(a, s, blocks, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9''s launch shape for B lanes of an (m, n, dc) code whose widest level
// has max_pairs real pairs and max_qubits qubits, into out[0..7]: blocks of
// the grid, warps a block, blocks resident on an SM, registers a thread,
// local (spill) bytes a thread, shared bytes a block (0: the slices are in
// device memory), the values of a warp's row of the cache scratch, and the
// bytes of a warp's slice. Each scratch has a row a warp of the grid; the
// slices' only where the shared bytes are 0. Returns 0 or the CUDA error of
// setting the kernel up.
int ldpc_mbp_shape(int max_pairs, int max_qubits, int m, int n, int dc, int min_sum, int f64,
                   int B, void* out) {
  Shape s;
  const int slice = slice_of(max_pairs, max_qubits, m, n, f64);
  const cudaError_t err = shape_for(slice, min_sum, f64, &s);
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  o[0] = grid_blocks(s, B);
  o[1] = kWarps;
  o[2] = s.per_sm;
  o[3] = s.regs;
  o[4] = s.local;
  o[5] = (int)s.smem;
  o[6] = m * row_stride(dc, f64 ? sizeof(double) : sizeof(float));
  o[7] = slice;
  return 0;
}

// Launches a grid of `blocks` blocks (ldpc_mbp_shape's; cache holds a row
// of the values it reports for each of their warps, and slices, where the
// shape puts them in device memory, a slice of the bytes it reports).
// Returns cudaGetLastError() after the launch (0 on success), the error of
// setting the kernel up, or cudaErrorInvalidValue for a grid the card
// cannot hold at once or slices missing. f64 selects the double instance
// (chan, inv_alpha, cache and llr are then double). beta and gamma are
// rounded to the scalar type once. next: one int32, 0 at launch. Nothing
// synchronises.
int ldpc_mbp(const void* synd, const void* chan, const void* inv_alpha, const void* chk_bits,
             const void* chk_val, const void* lv_bits, const void* lv_ptr,
             const void* pair_ptr, const void* pairs, int levels, int max_pairs,
             int max_qubits, int m, int n, int dc, int dv, int B, int max_iter, int min_sum,
             int f64, double beta, double gamma, int blocks, void* next, void* cache,
             void* slices, void* llr, void* dec, void* conv, void* iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return run<double>(synd, chan, inv_alpha, chk_bits, chk_val, lv_bits, lv_ptr, pair_ptr,
                       pairs, levels, max_pairs, max_qubits, m, n, dc, dv, B, max_iter,
                       min_sum, beta, gamma, blocks, next, cache, slices, llr, dec, conv,
                       iters, st);
  }
  return run<float>(synd, chan, inv_alpha, chk_bits, chk_val, lv_bits, lv_ptr, pair_ptr, pairs,
                    levels, max_pairs, max_qubits, m, n, dc, dv, B, max_iter, min_sum, beta,
                    gamma, blocks, next, cache, slices, llr, dec, conv, iters, st);
}

}  // extern "C"
