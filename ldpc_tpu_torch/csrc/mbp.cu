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
// syndromes in and the (B, 3, n) posteriors and (B, n) decisions out.
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
//     computes dv. A lane's state is the cache (m*dc values, 9,984 bytes
//     at d=13 in float64) and the widest level's messages.
//   - One warp a lane, a (qubit, slot) pair a thread in each of two passes
//     of a level: pass A forms each pair's stabilizer->qubit message from
//     its row's cached values (slot order, the own slot excluded) into the
//     lane's message scratch; after a __syncwarp, pass B forms the pair's
//     qubit posterior from the qubit's messages in slot order, writes the
//     posterior and decision once a qubit (slot 0's thread), and caches its
//     own edge's new value. No two pairs of a level touch one row's
//     entries that another pair writes, so the passes need only the one
//     __syncwarp between them and one after.
//   - Every sum, product and quotient is rounded once where the plain
//     version rounds it (__d*_rn / __f*_rn intrinsics, -fmad=false).
//     exp, log and tanh are CUDA's, the ones torch's CUDA kernels call, so
//     on the card the plain version and the kernel agree bit for bit
//     where their libraries agree; the comparison states its tolerance.
//   - Lane state in device memory. A lane's cache and messages live in a
//     lane-major device scratch, the decisions in the output, and its
//     accesses stay in L1/L2; posteriors go straight to the output each
//     time a qubit updates. A shared-memory variant measured beside it on
//     the H100 (16,384 surface-code lanes, min-sum; PERF.md) was slower at
//     d=9 float64 and d=13 in both types (34.2 against 15.4 ms at d=13
//     float64, the MBP workload), even at d=5 float64 and d=9 float32, and
//     ahead only at d=5 float32 (0.97 against 1.04 ms): shared memory
//     bounds the resident lanes by the state a block holds, device memory
//     does not.
//   - Templated on float64, the decoder's default, and float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 8;  // lanes (warps) a block

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
  const int* var_chks;      // (n, dv), pad m
  const int* var_slot;      // (n, dv)
  const uint8_t* var_val;   // (n, dv), pad 0
  const int* lv_bits;       // (n,) qubits level by level
  const int* lv_ptr;        // (levels + 1,)
  int levels, pairs;        // pairs: the widest level's qubits times dv
  int m, n, dc, dv, B, max_iter;
  T beta, gamma;
  T* cache;                 // (B, m*dc) scratch
  T* msg;                   // (B, pairs) scratch
  T* llr;                   // (B, 3, n) posteriors
  uint8_t* dec;             // (B, n) GF(4) decisions
  bool* conv;               // (B,)
  int* iters;               // (B,)
};

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

template <typename T, bool kMinSum>
__global__ void __launch_bounds__(32 * kLanes) mbp_kernel(const Args<T> a) {
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kLanes + w;
  if (b >= a.B) return;  // whole warps only; no block barrier follows
  const int m = a.m, n = a.n, dc = a.dc, dv = a.dv;
  const int E = m * dc;

  T* cache = a.cache + (size_t)b * E;
  T* msg = a.msg + (size_t)b * a.pairs;
  uint8_t* dec = a.dec + (size_t)b * n;
  const uint8_t* syn = a.synd + (size_t)b * m;
  T* llr = a.llr + (size_t)b * 3 * n;

  // each real edge's initial message: its qubit's channel LLR, 0 on the
  // agreeing Pauli
  for (int e = t; e < E; e += 32) {
    const int j = __ldg(a.chk_bits + e);
    T v = T(0);
    if (j < n) {
      const int val = __ldg(a.chk_val + e);
      const T q0 = val == 1 ? T(0) : __ldg(a.chan + j);
      const T q1 = val == 2 ? T(0) : __ldg(a.chan + n + j);
      const T q2 = val == 3 ? T(0) : __ldg(a.chan + 2 * n + j);
      v = edge_value<T, kMinSum>(q0, q1, q2, val);
    }
    cache[e] = v;
  }
  for (int j = t; j < n; j += 32) dec[j] = 0;
  __syncwarp();

  const T lo = sub_rn(T(1e-8), T(1)), hi = sub_rn(T(1), T(1e-8));
  bool converged = false;
  int it = 0;
  while (it < a.max_iter) {
    ++it;
    for (int l = 0; l < a.levels; ++l) {
      const int q0 = __ldg(a.lv_ptr + l);
      const int P = (__ldg(a.lv_ptr + l + 1) - q0) * dv;

      // ---- pass A: each pair's stabilizer->qubit message ---------------
      for (int p = t; p < P; p += 32) {
        const int j = __ldg(a.lv_bits + q0 + p / dv);
        const int k = p % dv;
        const int c = __ldg(a.var_chks + j * dv + k);
        T out = T(0);
        if (c < m) {
          const int own = __ldg(a.var_slot + j * dv + k);
          const int s = syn[c];
          if constexpr (kMinSum) {
            T mn = T(1e30);
            int negs = 0;
            for (int g = 0; g < dc; ++g) {
              if (g == own || __ldg(a.chk_bits + c * dc + g) >= n) continue;
              const T lam = cache[c * dc + g];
              const T x = abs_of(lam);
              mn = (mn != mn || x >= mn) ? mn : x;  // a NaN propagates
              negs += lam <= T(0);
            }
            const T r = mul_rn(a.gamma, mn);
            out = ((s + negs) & 1) ? -r : r;
          } else {
            T prod = T(1);
            for (int g = 0; g < dc; ++g) {
              if (g == own || __ldg(a.chk_bits + c * dc + g) >= n) continue;
              prod = mul_rn(prod, cache[c * dc + g]);
            }
            prod = prod < lo ? lo : prod;  // a NaN stays
            prod = prod > hi ? hi : prod;
            const T mag = log_of(div_rn(add_rn(T(1), prod), sub_rn(T(1), prod)));
            out = s ? -mag : mag;
          }
        }
        msg[p] = out;
      }
      __syncwarp();

      // ---- pass B: the qubit's posterior, decision and new edge values --
      for (int p = t; p < P; p += 32) {
        const int qi = p / dv;
        const int k = p % dv;
        const int j = __ldg(a.lv_bits + q0 + qi);
        const int c = __ldg(a.var_chks + j * dv + k);
        if (c >= m && k != 0) continue;
        const T ia0 = __ldg(a.inv_alpha + j), ia1 = __ldg(a.inv_alpha + n + j),
                ia2 = __ldg(a.inv_alpha + 2 * n + j);
        T acc0 = T(0), acc1 = T(0), acc2 = T(0);
        for (int kk = 0; kk < dv; ++kk) {
          const T mv = msg[qi * dv + kk];
          const int val = __ldg(a.var_val + j * dv + kk);
          const T on = __ldg(a.var_chks + j * dv + kk) < m ? T(1) : T(0);
          acc0 = add_rn(acc0, mul_rn(mul_rn(mv, val == 1 ? a.beta : ia0), on));
          acc1 = add_rn(acc1, mul_rn(mul_rn(mv, val == 2 ? a.beta : ia1), on));
          acc2 = add_rn(acc2, mul_rn(mul_rn(mv, val == 3 ? a.beta : ia2), on));
        }
        const T l0 = add_rn(__ldg(a.chan + j), acc0);
        const T l1 = add_rn(__ldg(a.chan + n + j), acc1);
        const T l2 = add_rn(__ldg(a.chan + 2 * n + j), acc2);
        if (k == 0) {
          llr[j] = l0;
          llr[n + j] = l1;
          llr[2 * n + j] = l2;
          // the first least Pauli (a NaN counts least), identity when all
          // three are positive
          int best = 0;
          T bv = l0;
          if (bv == bv && (l1 != l1 || l1 < bv)) { best = 1; bv = l1; }
          if (bv == bv && (l2 != l2 || l2 < bv)) { best = 2; bv = l2; }
          dec[j] = (l0 > T(0) && l1 > T(0) && l2 > T(0)) ? 0 : (uint8_t)(best + 1);
        }
        if (c < m) {
          const int val = __ldg(a.var_val + j * dv + k);
          const T mv = msg[p];
          const T n0 = sub_rn(l0, val == 1 ? T(0) : mv);
          const T n1 = sub_rn(l1, val == 2 ? T(0) : mv);
          const T n2 = sub_rn(l2, val == 3 ? T(0) : mv);
          cache[c * dc + __ldg(a.var_slot + j * dv + k)] = edge_value<T, kMinSum>(n0, n1, n2, val);
        }
      }
      __syncwarp();
    }

    // ---- the decisions' Pauli syndrome against the syndrome ---------------
    bool ok = true;
    for (int i = t; i < m && ok; i += 32) {
      int par = syn[i];
      for (int g = 0; g < dc; ++g) {
        const int j = __ldg(a.chk_bits + i * dc + g);
        if (j < n) {
          const int d = dec[j];
          par ^= (d != 0 && d != __ldg(a.chk_val + i * dc + g)) ? 1 : 0;
        }
      }
      ok = (par == 0);
    }
    converged = __all_sync(kFull, ok);
    if (converged) break;
  }

  if (t == 0) {
    a.conv[b] = converged;
    a.iters[b] = it;
  }
}

template <typename T, bool kMinSum>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int blocks = (a.B + kLanes - 1) / kLanes;
  mbp_kernel<T, kMinSum><<<blocks, 32 * kLanes, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* synd, const void* chan, const void* inv_alpha, const void* chk_bits,
        const void* chk_val, const void* var_chks, const void* var_slot, const void* var_val,
        const void* lv_bits, const void* lv_ptr, int levels, int pairs, int m, int n, int dc,
        int dv, int B, int max_iter, int min_sum, double beta, double gamma,
        void* cache, void* msg, void* llr, void* dec, void* conv, void* iters,
        cudaStream_t st) {
  Args<T> a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.chan = static_cast<const T*>(chan);
  a.inv_alpha = static_cast<const T*>(inv_alpha);
  a.chk_bits = static_cast<const int*>(chk_bits);
  a.chk_val = static_cast<const uint8_t*>(chk_val);
  a.var_chks = static_cast<const int*>(var_chks);
  a.var_slot = static_cast<const int*>(var_slot);
  a.var_val = static_cast<const uint8_t*>(var_val);
  a.lv_bits = static_cast<const int*>(lv_bits);
  a.lv_ptr = static_cast<const int*>(lv_ptr);
  a.levels = levels;
  a.pairs = pairs;
  a.m = m;
  a.n = n;
  a.dc = dc;
  a.dv = dv;
  a.B = B;
  a.max_iter = max_iter;
  a.beta = static_cast<T>(beta);
  a.gamma = static_cast<T>(gamma);
  a.cache = static_cast<T*>(cache);
  a.msg = static_cast<T*>(msg);
  a.llr = static_cast<T*>(llr);
  a.dec = static_cast<uint8_t*>(dec);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  return min_sum ? launch<T, true>(a, st) : launch<T, false>(a, st);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). f64 selects
// the double instance (chan, inv_alpha, cache, msg and llr are then
// double). beta and gamma are rounded to the scalar type once. cache (B,
// m*dc) and msg (B, pairs) are the lanes' scratch. Nothing synchronises.
int ldpc_mbp(const void* synd, const void* chan, const void* inv_alpha, const void* chk_bits,
             const void* chk_val, const void* var_chks, const void* var_slot,
             const void* var_val, const void* lv_bits, const void* lv_ptr, int levels,
             int pairs, int m, int n, int dc, int dv, int B, int max_iter, int min_sum,
             int f64, double beta, double gamma, void* cache, void* msg,
             void* llr, void* dec, void* conv, void* iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return run<double>(synd, chan, inv_alpha, chk_bits, chk_val, var_chks, var_slot, var_val,
                       lv_bits, lv_ptr, levels, pairs, m, n, dc, dv, B, max_iter, min_sum,
                       beta, gamma, cache, msg, llr, dec, conv, iters, st);
  }
  return run<float>(synd, chan, inv_alpha, chk_bits, chk_val, var_chks, var_slot, var_val,
                    lv_bits, lv_ptr, levels, pairs, m, n, dc, dv, B, max_iter, min_sum, beta,
                    gamma, cache, msg, llr, dec, conv, iters, st);
}

}  // extern "C"
