// K1': batched parallel-schedule belief propagation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ldpc_tpu/ops/bp_pallas.py::_bp_kernel_body
// (built by make_parallel_decoder_pallas). It computes exactly what the
// gather-only f32 engine ldpc_tpu/ops/bp.py::_make_parallel_decoder_fast
// computes, and what its plain PyTorch version
// ldpc_tpu_torch/ops/bp_cuda.py::bp_parallel_reference computes:
//   v2c = llr_post[bit] - c2v                      (extrinsic, per edge)
//   min-sum: exclusive min with first-occurrence argmin, sign parity of the
//            other slots (v <= 0 counts negative) XOR the syndrome bit,
//            scaled by alpha (fixed, or 1 - 2^-it when the factor is 0
//            unless dynamic_alpha is 0: single-scan, ldpc_tpu/ops/bp.py:135,
//            keeps the factor fixed even at 0);
//   product-sum: exclusive prefix/suffix tanh products clipped at
//            +-(1 - 1e-7), log((1+p)/(1-p)), signed by the syndrome bit;
//   llr_new = llr0 + (sum of the bit's c2v in slot order), llr0 the
//            channel prior: one (n,) vector for every lane, or a lane's own
//            row of a (B, n) prior (the analog-syndrome windows' per-shot
//            time-like priors, ldpc_tpu/ops/bp.py:185);
//   hard = llr_new <= 0; converged when every check's parity of hard bits
//            equals its syndrome bit, tested after each update.
// A lane stops at its first convergence, so its state when it stops is its
// output: decision, posterior and iteration count freeze there.
//
// The body is a template on the scalar type of the messages. float runs
// both methods; double runs min-sum, which is all single-scan in float64
// needs (ldpc_tpu/ops/bp.py:135-160 runs the fast engine at the decoder's
// dtype): the same recurrence v2c = post - c2v, every operation rounded
// once as the plain version rounds it (__dsub_rn, __dmul_rn, __dadd_rn and
// -fmad=false, as for float), the absent slots' magnitude 1e30 in double.
// Its state doubles: (m*dc + n)*8 bytes of messages and posteriors, 7.5 KB
// at d=13; above the per-lane budget the device-state variant takes it.
//
// What bounds it on the H100: neither bytes nor operations. A lane-iteration
// at d=13 is about 7k scalar operations on 4 KB of state, and the state
// never has to leave the SM; the work is a chain of dependent gathers
// (posterior -> message -> posterior) whose latency is what a lane waits on.
// The compulsory traffic is the syndromes in and the (B, n) posteriors and
// decisions out.
//
// What the design does about it:
//   - One warp per lane. The warp's threads stride over the checks for the
//     check update (one thread per check, its slots in slot order), over the
//     bits for the bit sum (one thread per bit, in var_edges slot order) and
//     over the checks again for the syndrome test, whose verdict is one
//     __all_sync. Each sum and each min is done by one thread in the plain
//     version's order and the build uses -fmad=false, so min-sum is
//     bit-identical to the plain version.
//   - The lane's state stays on chip for all its iterations: c2v (m*dc f32),
//     the posterior (n f32), the hard decisions (n u8) and the syndrome
//     (m u8), 4.2 KB at d=13 and 10.5 KB for the toric d=20 code. c2v is kept
//     slot-major (slot*m + check) so the threads of a warp, which own
//     consecutive checks, touch consecutive words. A block holds 4 lanes
//     (128 threads): every SM then keeps about 48 lanes resident at d=13, so
//     a bucket of about 6,000 lanes is one wave, and a block's lanes come
//     free together soon enough when lanes converge at different
//     iterations. Lanes never wait on each other: a converged lane leaves at
//     once, and there is no __syncthreads anywhere.
//   - The graph arrays (chk_bits and var_edges, both slot-major, and llr0)
//     are read through __ldg rather than staged into shared memory: every
//     warp of an SM reads the same 6 KB, which stays in L1, short-lived
//     blocks pay no staging, and the shared memory is left to lane state.
//     A (B, n) prior is the exception: each lane reads its own row, once in
//     the prologue and once a bit update, through the same __ldg path (the
//     rows are not kept in shared memory, whose room goes to lane state).
//   - No size cliff: when a lane's state exceeds kLaneBudget the same
//     template keeps c2v and the posterior in a lane-major scratch in
//     device memory (and the decisions in the output, the syndrome in the
//     input), still one warp per lane. ldpc_bp_shared_state tells the
//     wrapper which variant a code takes.
//   - I/O is lane-major: syndromes are read as (B, m) and the outputs are
//     written as (B, n), each warp on consecutive bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kBig = 1e30;  // absent slots' magnitude (ldpc_tpu.ops.bp._BIG)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanesPerBlock = 4;  // lanes (warps) per block
// A lane's state lives in shared memory up to this many bytes: at the
// budget a block takes 96 KB and two blocks (8 warps) still fit an SM;
// larger lanes keep c2v and the posterior in device memory.
constexpr size_t kLaneBudget = 24 * 1024;

// byte offsets of a lane's state in shared memory, each piece 16-aligned
struct LaneLayout {
  size_t post, hard, synd, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// elem: bytes of the scalar type (4 float, 8 double)
__host__ __device__ inline LaneLayout lane_layout(int m, int n, int E, size_t elem) {
  LaneLayout L;
  L.post = align16((size_t)E * elem);  // c2v at offset 0
  L.hard = L.post + align16((size_t)n * elem);
  L.synd = L.hard + align16((size_t)n);
  L.total = L.synd + align16((size_t)m);
  return L;
}

// every operation rounded once, in the type of its operands
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }

template <typename T>
struct Args {
  const uint8_t* synd;     // (B, m) 0/1
  const T* llr0;           // (n,), or (B, n) in the kLanePrior instances
  const int* chk_bits_t;   // (dc, m) slot-major, pad = n
  const int* var_edges_t;  // (dv, n) slot-major edge ids slot*m + check, pad = m*dc
  int m, n, dc, dv, B, max_iter;
  double ms_scaling;       // rounded to T once
  int dynamic_alpha;       // 0: alpha stays ms_scaling even when it is 0
  T* c2v;                  // (B, m*dc) scratch of the device-memory variant
  T* post;                 // (B, n) posterior
  uint8_t* dec;            // (B, n) hard decisions
  bool* conv;              // (B,)
  int* iters;              // (B,)
};

// Registers: at CAP <= 8 the compiler is held to 40 a thread in float so
// that 48 warps (12 blocks of 4 lanes) fit an SM, and to 64 in double,
// whose messages take two registers each; wider rows get more.
template <typename T, int CAP>
constexpr int min_blocks() {
  return CAP <= 8 ? (sizeof(T) == 4 ? 12 : 8) : (CAP <= 16 ? 6 : 1);
}

// kLanePrior: the prior is (B, n), lane b's row at llr0 + b * n; otherwise
// one (n,) prior for every lane. A template flag, so that the (n,)
// instances compile to the code they had before (B, n) priors existed.
template <typename T, int CAP, bool kMinSum, bool kShared, bool kLanePrior>
__global__ void __launch_bounds__(32 * kLanesPerBlock, (min_blocks<T, CAP>()))
    bp_warp_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= a.B) return;  // whole warps only; no block barrier follows
  const int m = a.m, n = a.n, dc = a.dc, dv = a.dv;
  const int E = m * dc;

  T* c2v;
  T* post;
  uint8_t* hard;
  const uint8_t* syn;
  if (kShared) {
    const LaneLayout L = lane_layout(m, n, E, sizeof(T));
    unsigned char* base = smem + (size_t)w * L.total;
    c2v = reinterpret_cast<T*>(base);
    post = reinterpret_cast<T*>(base + L.post);
    hard = base + L.hard;
    uint8_t* s = base + L.synd;
    const uint8_t* src = a.synd + (size_t)b * m;
    for (int i = t; i < m; i += 32) s[i] = src[i];
    syn = s;
  } else {
    c2v = a.c2v + (size_t)b * E;
    post = a.post + (size_t)b * n;
    hard = a.dec + (size_t)b * n;
    syn = a.synd + (size_t)b * m;
  }
  const T* prior = kLanePrior ? a.llr0 + (size_t)b * n : a.llr0;
  for (int j = t; j < n; j += 32) {
    post[j] = __ldg(prior + j);
    hard[j] = 0;
  }
  __syncwarp();

  bool converged = false;
  int it = 0;
  while (it < a.max_iter) {
    ++it;
    const T alpha = (kMinSum && a.dynamic_alpha && a.ms_scaling == 0.0)
                        ? sub_rn(T(1), static_cast<T>(ldexp(1.0, -it)))
                        : static_cast<T>(a.ms_scaling);

    // ---- check -> bit: one thread per check, slots in order -------------
    for (int i = t; i < m; i += 32) {
      const int s = syn[i];
      unsigned on = 0;  // bit k: slot k holds an edge
      if constexpr (kMinSum) {
        T mag[CAP];
        unsigned neg = 0;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          mag[k] = T(kBig);
          if (k < dc) {
            const int j = __ldg(a.chk_bits_t + k * m + i);
            if (j < n) {
              const T old = (it > 1) ? c2v[k * m + i] : T(0);
              const T v = sub_rn(post[j], old);
              mag[k] = abs_of(v);
              on |= 1u << k;
              if (v <= T(0)) neg |= 1u << k;
            }
          }
        }
        // first-occurrence argmin over the dc slots, then the minimum of
        // the other slots (kBig when there are none)
        T min1 = mag[0];
        int amin = 0;
#pragma unroll
        for (int k = 1; k < CAP; ++k) {
          if (k < dc && mag[k] < min1) {
            min1 = mag[k];
            amin = k;
          }
        }
        T min2 = T(kBig);
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          if (k < dc && k != amin && mag[k] < min2) min2 = mag[k];
        }
        const int base_par = s + __popc(neg);
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          if ((on >> k) & 1u) {
            // alpha * sign * excl with sign = +-1: the product rounds once
            const T r = mul_rn(alpha, (k == amin) ? min2 : min1);
            c2v[k * m + i] = ((base_par + (int)((neg >> k) & 1u)) & 1) ? -r : r;
          }
        }
      } else {
        float th[CAP];
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          th[k] = 1.0f;
          if (k < dc) {
            const int j = __ldg(a.chk_bits_t + k * m + i);
            if (j < n) {
              const float old = (it > 1) ? c2v[k * m + i] : 0.0f;
              th[k] = tanhf(__fmul_rn(__fsub_rn(post[j], old), 0.5f));
              on |= 1u << k;
            }
          }
        }
        float pre[CAP], suf[CAP];
        float acc = 1.0f;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          pre[k] = acc;
          if (k < dc) acc = __fmul_rn(acc, th[k]);
        }
        acc = 1.0f;
#pragma unroll
        for (int k = CAP - 1; k >= 0; --k) {
          suf[k] = acc;
          if (k < dc) acc = __fmul_rn(acc, th[k]);
        }
        const float lo = -1.0f + 1e-7f, hi = 1.0f - 1e-7f;
        const float sgn = s ? -1.0f : 1.0f;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          if ((on >> k) & 1u) {
            const float p = fminf(fmaxf(__fmul_rn(pre[k], suf[k]), lo), hi);
            const float mag = logf(__fdiv_rn(__fadd_rn(1.0f, p), __fsub_rn(1.0f, p)));
            c2v[k * m + i] = __fmul_rn(sgn, mag);
          }
        }
      }
    }
    __syncwarp();

    // ---- bit update and hard decision: one thread per bit ----------------
    for (int j = t; j < n; j += 32) {
      T acc = T(0);
      for (int k = 0; k < dv; ++k) {
        const int e = __ldg(a.var_edges_t + k * n + j);
        const T val = (e < E) ? c2v[e] : T(0);
        acc = (k == 0) ? val : add_rn(acc, val);
      }
      const T l = add_rn(__ldg(prior + j), acc);
      post[j] = l;
      hard[j] = (l <= T(0)) ? 1 : 0;
    }
    __syncwarp();

    // ---- syndrome test on the new decisions -------------------------------
    bool ok = true;
    for (int i = t; i < m && ok; i += 32) {
      int par = syn[i];
      for (int k = 0; k < dc; ++k) {
        const int j = __ldg(a.chk_bits_t + k * m + i);
        if (j < n) par ^= hard[j];
      }
      ok = (par == 0);
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
  }
  if (t == 0) {
    a.conv[b] = converged;
    a.iters[b] = it;
  }
}

template <typename T, int CAP, bool kMinSum, bool kShared, bool kLanePrior>
int launch(const Args<T>& a, cudaStream_t stream) {
  auto kernel = bp_warp_kernel<T, CAP, kMinSum, kShared, kLanePrior>;
  // a forced shared-state block above the card's opt-in limit fails here
  const size_t smem =
      kShared ? (size_t)kLanesPerBlock * lane_layout(a.m, a.n, a.m * a.dc, sizeof(T)).total
              : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // cleared: not the next launch's error
      return (int)err;
    }
  }
  const int blocks = (a.B + kLanesPerBlock - 1) / kLanesPerBlock;
  kernel<<<blocks, 32 * kLanesPerBlock, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int CAP, bool kMinSum>
int launch_state(const Args<T>& a, int shared, int lane_prior, cudaStream_t st) {
  if (shared) {
    return lane_prior ? launch<T, CAP, kMinSum, true, true>(a, st)
                      : launch<T, CAP, kMinSum, true, false>(a, st);
  }
  return lane_prior ? launch<T, CAP, kMinSum, false, true>(a, st)
                    : launch<T, CAP, kMinSum, false, false>(a, st);
}

template <int CAP>
int launch_cap(const Args<float>& a, int min_sum, int shared, int lane_prior,
               cudaStream_t st) {
  return min_sum ? launch_state<float, CAP, true>(a, shared, lane_prior, st)
                 : launch_state<float, CAP, false>(a, shared, lane_prior, st);
}

// double: min-sum only (the wrapper refuses product-sum in float64)
template <int CAP>
int launch_cap(const Args<double>& a, int min_sum, int shared, int lane_prior,
               cudaStream_t st) {
  if (!min_sum) return (int)cudaErrorInvalidValue;
  return launch_state<double, CAP, true>(a, shared, lane_prior, st);
}

template <typename T>
int launch_dc(const Args<T>& a, int min_sum, int shared, int lane_prior, cudaStream_t st) {
  if (a.dc <= 4) return launch_cap<4>(a, min_sum, shared, lane_prior, st);
  if (a.dc <= 8) return launch_cap<8>(a, min_sum, shared, lane_prior, st);
  if (a.dc <= 16) return launch_cap<16>(a, min_sum, shared, lane_prior, st);
  if (a.dc <= 32) return launch_cap<32>(a, min_sum, shared, lane_prior, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const void* synd, const void* llr0, int lane_prior, const void* chk_bits_t,
        const void* var_edges_t, int m, int n, int dc, int dv, int B, int max_iter,
        int min_sum, double ms_scaling, int dynamic_alpha, int shared, void* c2v,
        void* post, void* dec, void* conv, void* iters, cudaStream_t st) {
  Args<T> a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.llr0 = static_cast<const T*>(llr0);
  a.chk_bits_t = static_cast<const int*>(chk_bits_t);
  a.var_edges_t = static_cast<const int*>(var_edges_t);
  a.m = m;
  a.n = n;
  a.dc = dc;
  a.dv = dv;
  a.B = B;
  a.max_iter = max_iter;
  a.ms_scaling = ms_scaling;
  a.dynamic_alpha = dynamic_alpha;
  a.c2v = static_cast<T*>(c2v);
  a.post = static_cast<T*>(post);
  a.dec = static_cast<uint8_t*>(dec);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  return launch_dc<T>(a, min_sum, shared, lane_prior, st);
}

}  // namespace

extern "C" {

// 1 when a lane's state of an (m, n, dc) code in a scalar of elem bytes
// fits kLaneBudget, so the shared-memory variant is the default; 0 for the
// device-memory variant.
int ldpc_bp_shared_state(int m, int n, int dc, int elem) {
  return lane_layout(m, n, m * dc, (size_t)elem).total <= kLaneBudget ? 1 : 0;
}

// Returns cudaGetLastError() after the launch (0 on success), or the error
// of raising the block's shared-memory limit. f64 selects the double
// instance (llr0, c2v and post are then double; min-sum only). llr0 is one
// (n,) prior (lane_prior 0) or a lane-major (B, n) prior (lane_prior 1).
// The caller checks dc <= 32 and allocates every buffer; c2v is read only
// by the device-memory variant (shared == 0). Nothing synchronises.
int ldpc_bp_parallel(const void* synd, const void* llr0, int lane_prior,
                     const void* chk_bits_t, const void* var_edges_t, int m, int n, int dc, int dv,
                     int B, int max_iter, int min_sum, double ms_scaling,
                     int dynamic_alpha, int shared, int f64, void* c2v, void* post,
                     void* dec, void* conv, void* iters, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return run<double>(synd, llr0, lane_prior, chk_bits_t, var_edges_t, m, n, dc, dv, B,
                       max_iter, min_sum, ms_scaling, dynamic_alpha, shared, c2v, post, dec, conv,
                       iters, st);
  }
  return run<float>(synd, llr0, lane_prior, chk_bits_t, var_edges_t, m, n, dc, dv, B,
                    max_iter, min_sum, ms_scaling, dynamic_alpha, shared, c2v, post, dec, conv,
                    iters, st);
}

const char* ldpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
