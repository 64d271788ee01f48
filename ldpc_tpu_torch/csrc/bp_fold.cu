// K6', K7', K8': the fold-exact BP engines for Hopper (sm_90a), on one template.
//
// None of the three replaces a Pallas kernel: each is an XLA loop of the JAX
// package, written here by hand because in PyTorch its sequential steps would
// be thousands of launches a call (n bits x iterations x some 30 ops).
//   K6' (kSerial) replaces ldpc_tpu/ops/bp.py:496 make_serial_decoder: a
//       fori_loop over the n bits inside a while_loop over iterations,
//       vmapped over the batch. Bits update one at a time in a schedule:
//       a given order (serial), one permutation per iteration read from a
//       table (random serial), or the lane's posteriors ranked most reliable
//       first at the start of each iteration (serial-relative, a stable
//       descending order: equal keys keep index order, NaN last).
//   K7' (kSoftInfo) replaces ldpc_tpu/ops/bp.py:349 make_soft_info_decoder:
//       serial min-sum in index order over soft syndromes (already scaled by
//       2/sigma^2), whose virtual-update rules shrink or flip a check's soft
//       and hard syndrome during the sweep; the final soft syndrome is an
//       output.
//   K8' (kExact) replaces ldpc_tpu/ops/bp.py:251 _make_parallel_decoder_
//       exact: parallel BP that stores bit-to-check messages, float64.
// Each takes the reference's steps in its order, as its plain PyTorch version
// in ldpc_tpu_torch/ops/bp_fold.py does:
//   - a bit's posterior is the channel LLR plus its c2v messages in slot order
//     (a left fold), and its message into slot k is the fold of the slots
//     before k plus the reverse fold of the slots after it, from the last down
//     (bp.hpp:277-318, 500-535);
//   - min-sum: the minimum |message| of a check's other slots, absent ones
//     counting 1e30, signed by the parity of the others' signs (v <= 0 counts
//     negative) and the syndrome, scaled by alpha (fixed, or 1 - 2^-it when
//     the factor is 0; K7' always fixed); K8' takes the exclusive minimum with
//     the first-occurrence argmin as K1' does;
//   - product-sum: the product of tanh(v/2) over the other slots in row order
//     (K8': exclusive prefix and suffix products), clipped to +-(1 - 1e-7) in
//     float32 only, then log((1+p)/(1-p)) signed by the syndrome bit;
//   - a lane converges when the parity of its hard decisions equals its
//     (K7': current) syndrome, tested after each iteration, and stops there.
// Every sum and product is taken by one thread in that order and the build
// uses -fmad=false, so min-sum is bit-identical to the plain version.
//
// What bounds them on the H100: the latency of a lane's chain, not bytes or
// operations. K6' and K7' are n dependent steps an iteration (load the bit's
// edges, read its checks' rows, fold, write its messages; each step reads
// what the step before wrote); K8' is K1''s dependent gather chain. A lane's
// compulsory traffic is its syndrome in and its (n,) posteriors and decisions
// out.
//
// What the design does about it (a simple kernel that is right first; the
// scan over several bits whose checks are disjoint, as flip.cu scans, is for
// a later PR):
//   - One warp per lane and one lane a block, no block barrier: a converged
//     lane leaves at once and its block's shared memory and registers come
//     free for the next lane, so the long sweeps of the lanes BP fails (at
//     d=13 two thirds of the lane-iterations) do not hold finished lanes'
//     slots (it beat 2 and 4 lanes a block on the H100; see PERF.md). In
//     K6'/K7' the warp's threads take the bit's dv checks (one thread a
//     check, its row in row order), the c2v values meet in a dv-entry
//     scratch, and each slot's thread folds its own message; in K8' threads
//     stride over checks, then over bits, as in K1'.
//   - A lane's state (messages m*dc, posteriors n, decisions n, syndrome m;
//     K7' its soft syndrome m; serial-relative its schedule n) lives in shared
//     memory while it fits kLaneBudget, otherwise in a lane-major scratch in
//     device memory (same template, still one warp per lane), so no code is
//     refused for its size. ldpc_bp_fold_shared_state tells the wrapper which.
//   - The graph arrays and the schedule are read through __ldg: every warp of
//     an SM reads the same few KB, which stay in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// A lane's state lives in shared memory up to this many bytes (K1''s budget:
// 9 lanes at the budget fit an SM).
constexpr size_t kLaneBudget = 24 * 1024;

enum Engine { kSerial = 0, kSoftInfo = 1, kExact = 2 };
enum OrderMode { kOrderFixed = 0, kOrderTable = 1, kOrderRelative = 2 };

template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 1e30f; }
template <> __device__ __forceinline__ double big<double>() { return 1e30; }

__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
// the product-sum clip, float32 only (float64 keeps the saturation to inf)
__device__ __forceinline__ float clip_(float p) {
  return fminf(fmaxf(p, -1.0f + 1e-7f), 1.0f - 1e-7f);
}
__device__ __forceinline__ double clip_(double p) { return p; }
// the dynamic min-sum factor 1 - 2^-it, rounded once in T
__device__ __forceinline__ float dynamic_alpha(float, int it) { return 1.0f - ldexpf(1.0f, -it); }
__device__ __forceinline__ double dynamic_alpha(double, int it) { return 1.0 - ldexp(1.0, -it); }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of a lane's pieces in shared memory, each 16-aligned: its whole
// state in the shared variant; in the device variant only the dv c2v values of
// the bit in hand (K6', K7'), the rest lives in device memory.
struct Layout {
  size_t msg, post, hard, synd, soft, sched, c2v, total;
};

__host__ __device__ inline Layout lane_layout(int engine, int m, int n, int dc, int dv,
                                              int elem, bool relative, bool shared) {
  Layout L{};
  size_t off = 0;
  if (shared) {
    L.msg = off;
    off += align16((size_t)m * dc * elem);
    L.post = off;
    off += align16((size_t)n * elem);
    L.hard = off;
    off += align16((size_t)n);
    L.synd = off;
    off += align16((size_t)m);
    if (engine == kSoftInfo) {
      L.soft = off;
      off += align16((size_t)m * elem);
    }
    if (relative) {
      L.sched = off;
      off += align16((size_t)n * sizeof(int));
    }
  }
  if (engine != kExact) {
    L.c2v = off;
    off += align16((size_t)dv * elem);
  }
  L.total = off;
  return L;
}

template <typename T>
struct FoldArgs {
  const uint8_t* synd;     // (B, m) 0/1 syndromes (K6', K8')
  const T* soft_in;        // (B, m) scaled soft syndromes (K7')
  const T* llr0;           // (n,) channel LLRs
  // K6'/K7': chk_bits (m, dc) check-major and var_edges (n, dv) ids c*dc+slot;
  // K8': chk_bits (dc, m) slot-major and var_edges (dv, n) ids slot*m+c.
  // pad: chk_bits n, var_edges m*dc; a row's and a column's slots are filled
  // first, pads last
  const int* chk_bits;
  const int* var_edges;
  const int* order;        // K6': (n,) fixed or (max_iter, n) table
  int m, n, dc, dv, B, max_iter, order_mode;
  T ms_scaling, cutoff;
  // device variant: lane-major scratch
  T* msg;                  // (B, m*dc) messages
  int* sched;              // (B, n) the serial-relative schedule
  uint8_t* synd_work;      // (B, m) K7''s hard syndrome
  // outputs
  T* post;                 // (B, n)
  uint8_t* dec;            // (B, n)
  T* soft_out;             // (B, m) K7'
  bool* conv;              // (B,)
  int* iters;              // (B,)
};

// One bit of a serial sweep (K6' and, kSoft, K7'): the c2v of each of the
// bit's checks from its row, then the bit's posterior and its messages.
template <typename T, bool kMinSum, bool kSoft>
__device__ __forceinline__ void serial_step(const FoldArgs<T>& a, int j, int t, T alpha,
                                            T* msg, T* c2v, T* post, uint8_t* hard,
                                            uint8_t* syn, T* soft) {
  const int n = a.n, dc = a.dc, dv = a.dv, E = a.m * dc;
  const int* edges = a.var_edges + (size_t)j * dv;
  int deg = 0;  // the bit's slots are filled first, pads last
  for (int k0 = 0; k0 < dv; k0 += 32) {
    const int k = k0 + t;
    const int e = k < dv ? __ldg(edges + k) : E;
    if (e < E) {
      const int c = e / dc;
      const int own = e - c * dc;
      const int* bits = a.chk_bits + (size_t)c * dc;
      const T* row = msg + (size_t)c * dc;
      T v;
      if (kMinSum) {
        T temp = big<T>();
        int negs = 0;
        for (int s = 0; s < dc; ++s) {
          if (s == own || __ldg(bits + s) >= n) continue;
          const T x = row[s];
          const T mag = abs_(x);
          temp = mag < temp ? mag : temp;
          negs += x <= T(0);
        }
        if (kSoft) {
          // the virtual-update rules (ldpc_tpu/ops/bp.py:402-418)
          const T cur = row[own];
          const T ss = soft[c];
          const int s = syn[c];
          const T ss_mag = abs_(ss);
          const bool virt = ss_mag < a.cutoff && ss_mag < temp;
          const T prop = virt ? ss_mag : temp;
          const bool agree = ((negs + (cur <= T(0))) & 1) == s;
          const T cur_mag = abs_(cur);
          const T shrink = cur_mag < temp ? cur_mag : temp;
          T ss_new = ss;
          int s_new = s;
          if (virt && agree) {
            ss_new = s ? -shrink : shrink;
          } else if (virt) {
            ss_new = -ss;
            s_new = s ^ 1;
          }
          soft[c] = ss_new;  // check c is this thread's alone during the step
          syn[c] = (uint8_t)s_new;
          const T r = alpha * prop;
          v = ((negs + s_new) & 1) ? -r : r;
        } else {
          const T r = alpha * temp;
          v = ((syn[c] + negs) & 1) ? -r : r;
        }
      } else {
        T p = T(1);
        for (int s = 0; s < dc; ++s) {
          if (s == own || __ldg(bits + s) >= n) continue;
          p = p * tanh_(row[s] * T(0.5));
        }
        p = clip_(p);
        const T mag = log_((T(1) + p) / (T(1) - p));
        v = syn[c] ? -mag : mag;
      }
      c2v[k] = v;
    }
    deg += __popc(__ballot_sync(kFull, e < E));
  }
  __syncwarp();
  const T l0 = __ldg(a.llr0 + j);
  for (int k = t; k < deg; k += 32) {
    T part = l0;  // channel + the slots before k, left fold
    for (int q = 0; q < k; ++q) part = part + c2v[q];
    T suf = T(0);  // the slots after k, from the last down
    for (int q = deg - 1; q > k; --q) suf = suf + c2v[q];
    msg[__ldg(edges + k)] = part + suf;
  }
  if (t == 0) {
    T l = l0;
    for (int q = 0; q < deg; ++q) l = l + c2v[q];
    post[j] = l;
    hard[j] = l <= T(0);
  }
  __syncwarp();
}

// One iteration of K8': check update in place over the messages, then each
// bit's posterior and its new bit-to-check messages, in place again.
template <typename T, bool kMinSum, int CAP>
__device__ __forceinline__ void exact_iteration(const FoldArgs<T>& a, int t, T alpha, T* msg,
                                                T* post, uint8_t* hard, const uint8_t* syn) {
  const int m = a.m, n = a.n, dc = a.dc, dv = a.dv, E = m * dc;
  for (int i = t; i < m; i += 32) {
    const int s = syn[i];
    if constexpr (kMinSum) {
      // one pass in slot order: the first-occurrence argmin and min1, and
      // min2 = min(1e30, the other slots), absent slots counting 1e30
      T min1 = big<T>(), min2 = big<T>();
      int amin = 0;
      int negs = 0;
      for (int k = 0; k < dc; ++k) {
        T mag = big<T>();
        if (__ldg(a.chk_bits + k * m + i) < n) {
          const T v = msg[k * m + i];
          mag = abs_(v);
          negs += v <= T(0);
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
        if (__ldg(a.chk_bits + k * m + i) >= n) continue;
        const T v = msg[k * m + i];
        const T r = alpha * (k == amin ? min2 : min1);
        msg[k * m + i] = ((s + negs + (v <= T(0))) & 1) ? -r : r;
      }
    } else {
      T th[CAP];
      unsigned on = 0;
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        th[k] = T(1);
        if (k < dc && __ldg(a.chk_bits + k * m + i) < n) {
          th[k] = tanh_(msg[k * m + i] * T(0.5));
          on |= 1u << k;
        }
      }
      T pre[CAP], suf[CAP];
      T acc = T(1);
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        pre[k] = acc;
        if (k < dc) acc = acc * th[k];
      }
      acc = T(1);
#pragma unroll
      for (int k = CAP - 1; k >= 0; --k) {
        suf[k] = acc;
        if (k < dc) acc = acc * th[k];
      }
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        if ((on >> k) & 1u) {
          const T p = clip_(pre[k] * suf[k]);
          const T mag = log_((T(1) + p) / (T(1) - p));
          msg[k * m + i] = s ? -mag : mag;
        }
      }
    }
  }
  __syncwarp();
  for (int j = t; j < n; j += 32) {
    const T l0 = __ldg(a.llr0 + j);
    T l = l0;
    int deg = 0;
    for (int k = 0; k < dv; ++k) {
      const int e = __ldg(a.var_edges + k * n + j);
      if (e >= E) break;
      l = l + msg[e];
      ++deg;
    }
    post[j] = l;
    hard[j] = l <= T(0);
    // the bit's messages from the last slot down: slot k's partial folds the
    // slots before k, which are still c2v values when it is written
    T suf = T(0);
    for (int k = deg - 1; k >= 0; --k) {
      const int e = __ldg(a.var_edges + k * n + j);
      const T c = msg[e];
      T part = l0;
      for (int q = 0; q < k; ++q) part = part + msg[__ldg(a.var_edges + q * n + j)];
      msg[e] = part + suf;
      suf = suf + c;
    }
  }
  __syncwarp();
}

// The serial-relative schedule: bit j goes to its rank among the lane's
// posteriors, most reliable first, equal keys in index order, NaN last
// (torch.argsort(-post, stable=True)).
template <typename T>
__device__ __forceinline__ void rank_bits(int n, int t, const T* post, int* sched) {
  for (int j = t; j < n; j += 32) {
    const T key = post[j];
    const bool key_nan = key != key;
    int r = 0;
    for (int i = 0; i < n; ++i) {
      const T o = post[i];
      const bool o_nan = o != o;
      r += (o > key) || (!o_nan && key_nan) || ((o == key || (o_nan && key_nan)) && i < j);
    }
    sched[r] = j;
  }
  __syncwarp();
}

template <typename T, int kEngine, bool kMinSum, bool kShared, int CAP>
__global__ void __launch_bounds__(32) fold_kernel(const FoldArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;  // a block is one warp, one lane
  const int b = blockIdx.x;
  const int m = a.m, n = a.n, dc = a.dc, E = m * dc;
  const bool relative = kEngine == kSerial && a.order_mode == kOrderRelative;
  const Layout L = lane_layout(kEngine, m, n, dc, a.dv, sizeof(T), relative, kShared);
  unsigned char* base = smem;
  T* c2v = reinterpret_cast<T*>(base + L.c2v);
  T* msg;
  T* post;
  uint8_t* hard;
  uint8_t* syn;
  T* soft = nullptr;
  int* sched = nullptr;
  if (kShared) {
    msg = reinterpret_cast<T*>(base + L.msg);
    post = reinterpret_cast<T*>(base + L.post);
    hard = base + L.hard;
    syn = base + L.synd;
    if (kEngine == kSoftInfo) soft = reinterpret_cast<T*>(base + L.soft);
    if (relative) sched = reinterpret_cast<int*>(base + L.sched);
    if (kEngine != kSoftInfo) {
      const uint8_t* src = a.synd + (size_t)b * m;
      for (int i = t; i < m; i += 32) syn[i] = src[i];
    }
  } else {
    msg = a.msg + (size_t)b * E;
    post = a.post + (size_t)b * n;
    hard = a.dec + (size_t)b * n;
    // K6' and K8' only read the syndrome: the input serves
    syn = kEngine == kSoftInfo ? a.synd_work + (size_t)b * m
                               : const_cast<uint8_t*>(a.synd + (size_t)b * m);
    if (kEngine == kSoftInfo) soft = a.soft_out + (size_t)b * m;
    if (relative) sched = a.sched + (size_t)b * n;
  }
  if (kEngine == kSoftInfo) {
    const T* src = a.soft_in + (size_t)b * m;
    for (int i = t; i < m; i += 32) {
      const T s = src[i];
      soft[i] = s;
      syn[i] = s <= T(0);
    }
  }
  // bit-to-check messages start at the channel LLR of the edge's bit
  for (int e = t; e < E; e += 32) {
    const int j = __ldg(a.chk_bits + e);
    msg[e] = j < n ? __ldg(a.llr0 + j) : T(0);
  }
  for (int j = t; j < n; j += 32) {
    post[j] = __ldg(a.llr0 + j);
    hard[j] = 0;
  }
  __syncwarp();

  bool converged = false;
  int it = 0;
  while (it < a.max_iter) {
    ++it;
    const T alpha = (kMinSum && kEngine != kSoftInfo && a.ms_scaling == T(0))
                        ? dynamic_alpha(T(0), it)
                        : a.ms_scaling;
    if constexpr (kEngine == kExact) {
      exact_iteration<T, kMinSum, CAP>(a, t, alpha, msg, post, hard, syn);
    } else {
      if (relative) rank_bits(n, t, post, sched);
      const int* row = a.order_mode == kOrderTable ? a.order + (size_t)(it - 1) * n : a.order;
      for (int idx = 0; idx < n; ++idx) {
        const int j = relative ? sched[idx] : (kEngine == kSoftInfo ? idx : __ldg(row + idx));
        serial_step<T, kMinSum, kEngine == kSoftInfo>(a, j, t, alpha, msg, c2v, post, hard,
                                                      syn, soft);
      }
    }
    // syndrome test on the new decisions
    bool ok = true;
    for (int i = t; i < m && ok; i += 32) {
      int par = syn[i];
      for (int k = 0; k < dc; ++k) {
        const int j = kEngine == kExact ? __ldg(a.chk_bits + k * m + i)
                                        : __ldg(a.chk_bits + (size_t)i * dc + k);
        if (j < n) par ^= hard[j];
      }
      ok = par == 0;
    }
    converged = __all_sync(kFull, ok);
    if (converged) break;
  }

  if (kShared) {
    T* po = a.post + (size_t)b * n;
    uint8_t* de = a.dec + (size_t)b * n;
    for (int j = t; j < n; j += 32) {
      po[j] = post[j];
      de[j] = hard[j];
    }
    if (kEngine == kSoftInfo) {
      T* so = a.soft_out + (size_t)b * m;
      for (int i = t; i < m; i += 32) so[i] = soft[i];
    }
  }
  if (t == 0) {
    a.conv[b] = converged;
    a.iters[b] = it;
  }
}

template <typename T, int kEngine, bool kMinSum, bool kShared, int CAP>
int launch(const FoldArgs<T>& a, cudaStream_t stream) {
  auto kernel = fold_kernel<T, kEngine, kMinSum, kShared, CAP>;
  const bool relative = kEngine == kSerial && a.order_mode == kOrderRelative;
  const size_t smem =
      lane_layout(kEngine, a.m, a.n, a.dc, a.dv, sizeof(T), relative, kShared).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // cleared: not the next launch's error
      return (int)err;
    }
  }
  kernel<<<a.B, 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kEngine, bool kMinSum, int CAP = 1>
int launch_state(const FoldArgs<T>& a, int shared, cudaStream_t st) {
  return shared ? launch<T, kEngine, kMinSum, true, CAP>(a, st)
                : launch<T, kEngine, kMinSum, false, CAP>(a, st);
}

template <typename T>
FoldArgs<T> make_args(const void* synd, const void* soft_in, const void* llr0,
                      const void* chk_bits, const void* var_edges, const void* order, int m,
                      int n, int dc, int dv, int B, int max_iter, int order_mode,
                      double ms_scaling, double cutoff, void* msg, void* sched,
                      void* synd_work, void* post, void* dec, void* soft_out, void* conv,
                      void* iters) {
  FoldArgs<T> a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.soft_in = static_cast<const T*>(soft_in);
  a.llr0 = static_cast<const T*>(llr0);
  a.chk_bits = static_cast<const int*>(chk_bits);
  a.var_edges = static_cast<const int*>(var_edges);
  a.order = static_cast<const int*>(order);
  a.m = m;
  a.n = n;
  a.dc = dc;
  a.dv = dv;
  a.B = B;
  a.max_iter = max_iter;
  a.order_mode = order_mode;
  a.ms_scaling = (T)ms_scaling;  // rounded once to T, as the reference's scalar
  a.cutoff = (T)cutoff;
  a.msg = static_cast<T*>(msg);
  a.sched = static_cast<int*>(sched);
  a.synd_work = static_cast<uint8_t*>(synd_work);
  a.post = static_cast<T*>(post);
  a.dec = static_cast<uint8_t*>(dec);
  a.soft_out = static_cast<T*>(soft_out);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  return a;
}

template <typename T>
int serial_dispatch(const FoldArgs<T>& a, int min_sum, int shared, cudaStream_t st) {
  return min_sum ? launch_state<T, kSerial, true>(a, shared, st)
                 : launch_state<T, kSerial, false>(a, shared, st);
}

template <int CAP>
int exact_product_sum(const FoldArgs<double>& a, int shared, cudaStream_t st) {
  return launch_state<double, kExact, false, CAP>(a, shared, st);
}

}  // namespace

extern "C" {

// 1 when a lane of engine (0 K6', 1 K7', 2 K8') on an (m, n, dc, dv) code in
// elements of elem bytes fits kLaneBudget, so the shared-memory variant is
// the default; 0 for the device-memory variant.
int ldpc_bp_fold_shared_state(int engine, int m, int n, int dc, int dv, int elem,
                              int relative) {
  return lane_layout(engine, m, n, dc, dv, elem, relative != 0, true).total <= kLaneBudget;
}

// K6'. order: (n,) int32 for order_mode 0, (max_iter, n) for 1, unused for 2.
// f64 selects double for llr0, post and msg. The device variant (shared == 0)
// reads msg (B, m*dc) and, serial-relative, sched (B, n). Returns
// cudaGetLastError() after the launch (0 on success) or the error of raising
// the block's shared-memory limit. Nothing synchronises.
int ldpc_bp_serial(const void* synd, const void* llr0, const void* chk_bits,
                   const void* var_edges, const void* order, int m, int n, int dc, int dv,
                   int B, int max_iter, int order_mode, int min_sum, int f64,
                   double ms_scaling, int shared, void* msg, void* sched, void* post,
                   void* dec, void* conv, void* iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return serial_dispatch(
        make_args<double>(synd, nullptr, llr0, chk_bits, var_edges, order, m, n, dc, dv, B,
                          max_iter, order_mode, ms_scaling, 0.0, msg, sched, nullptr, post,
                          dec, nullptr, conv, iters),
        min_sum, shared, st);
  }
  return serial_dispatch(
      make_args<float>(synd, nullptr, llr0, chk_bits, var_edges, order, m, n, dc, dv, B,
                       max_iter, order_mode, ms_scaling, 0.0, msg, sched, nullptr, post, dec,
                       nullptr, conv, iters),
      min_sum, shared, st);
}

// K7' (min-sum). soft_in: (B, m) soft syndromes already scaled by 2/sigma^2,
// in the engine's type; soft_out (B, m) receives the final soft syndrome. The
// device variant reads msg (B, m*dc) and synd (B, m) uint8 scratch.
int ldpc_bp_soft_info(const void* soft_in, const void* llr0, const void* chk_bits,
                      const void* var_edges, int m, int n, int dc, int dv, int B,
                      int max_iter, int f64, double ms_scaling, double cutoff, int shared,
                      void* msg, void* synd, void* post, void* dec, void* soft_out,
                      void* conv, void* iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return launch_state<double, kSoftInfo, true>(
        make_args<double>(nullptr, soft_in, llr0, chk_bits, var_edges, nullptr, m, n, dc, dv,
                          B, max_iter, kOrderFixed, ms_scaling, cutoff, msg, nullptr, synd,
                          post, dec, soft_out, conv, iters),
        shared, st);
  }
  return launch_state<float, kSoftInfo, true>(
      make_args<float>(nullptr, soft_in, llr0, chk_bits, var_edges, nullptr, m, n, dc, dv, B,
                       max_iter, kOrderFixed, ms_scaling, cutoff, msg, nullptr, synd, post,
                       dec, soft_out, conv, iters),
      shared, st);
}

// K8' (float64). chk_bits_t (dc, m) and var_edges_t (dv, n) are the slot-major
// views K1' takes. The caller checks dc <= 32 (product-sum keeps a row in
// registers). The device variant reads msg (B, m*dc).
int ldpc_bp_parallel_exact(const void* synd, const void* llr0, const void* chk_bits_t,
                           const void* var_edges_t, int m, int n, int dc, int dv, int B,
                           int max_iter, int min_sum, double ms_scaling, int shared, void* msg,
                           void* post, void* dec, void* conv, void* iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const FoldArgs<double> a =
      make_args<double>(synd, nullptr, llr0, chk_bits_t, var_edges_t, nullptr, m, n, dc, dv,
                        B, max_iter, kOrderFixed, ms_scaling, 0.0, msg, nullptr, nullptr,
                        post, dec, nullptr, conv, iters);
  if (min_sum) return launch_state<double, kExact, true>(a, shared, st);
  if (dc <= 4) return exact_product_sum<4>(a, shared, st);
  if (dc <= 8) return exact_product_sum<8>(a, shared, st);
  if (dc <= 16) return exact_product_sum<16>(a, shared, st);
  if (dc <= 32) return exact_product_sum<32>(a, shared, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
