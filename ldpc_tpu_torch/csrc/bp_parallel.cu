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
//            scaled by alpha (fixed, or 1 - 2^-it when the factor is 0);
//   product-sum: exclusive prefix/suffix tanh products clipped at
//            +-(1 - 1e-7), log((1+p)/(1-p)), signed by the syndrome bit;
//   llr_new = llr0 + (sum of the bit's c2v in slot order);
//   hard = llr_new <= 0; converged when every check's parity of hard bits
//            equals its syndrome bit, tested after each update.
// A lane stops at its first convergence, so its state when it stops is its
// output: decision, posterior and iteration count freeze there.
//
// What bounds it on the H100: memory traffic, not arithmetic. One thread
// owns one syndrome lane; per iteration it reads every edge's c2v and its
// bit's posterior and writes c2v back (m*dc*12 bytes), then reads dv c2v per
// bit and writes the posterior and decision (n*(4*dv+5) bytes), then reads
// the decisions again for the syndrome test. At d=13 that is about 13 KB
// per lane per iteration against a handful of flops per byte.
//
// What the design does about it: all state is batch-minor ((edge, lane) and
// (bit, lane)), so the 32 lanes of a warp touch 32 consecutive words on
// every access and each access is one coalesced transaction. The graph's
// index arrays are read through __ldg and are the same address for every
// lane of a warp (a broadcast). A lane leaves the iteration loop as soon as
// it converges, so the ~90% of lanes that converge in a few iterations stop
// moving bytes. The TPU kernel's one-hot MXU gathers, (8,128) padding and
// f32 blends are not carried over: the kernel indexes the ELL arrays
// directly. Shared-memory tiling is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;  // absent slots' magnitude (ldpc_tpu.ops.bp._BIG)

template <int CAP>
__global__ void bp_parallel_kernel(
    const uint8_t* __restrict__ synd,      // (m, B) 0/1
    const float* __restrict__ llr0,        // (n,)
    const int* __restrict__ chk_bits,      // (m*dc,) pad = n
    const int* __restrict__ var_edges,     // (n*dv,) pad = m*dc
    int m, int n, int dc, int dv, int B, int max_iter, int min_sum,
    float ms_scaling,
    float* __restrict__ c2v,               // (m*dc, B) scratch
    float* __restrict__ llr,               // (n, B) posterior (state = output)
    uint8_t* __restrict__ dec,             // (n, B) hard decisions
    bool* __restrict__ conv,               // (B,)
    int* __restrict__ iters) {             // (B,)
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int E = m * dc;

  for (int j = 0; j < n; ++j) {
    llr[j * sB + b] = __ldg(llr0 + j);
    dec[j * sB + b] = 0;
  }

  bool converged = false;
  int it = 0;
  while (it < max_iter && !converged) {
    ++it;
    const float alpha = (min_sum && ms_scaling == 0.0f)
                            ? 1.0f - ldexpf(1.0f, -it)
                            : ms_scaling;

    // ---- check -> bit ------------------------------------------------
    for (int i = 0; i < m; ++i) {
      const int s = synd[i * sB + b];
      int bit[CAP];
      float v[CAP];
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        bit[k] = (k < dc) ? __ldg(chk_bits + i * dc + k) : n;
        v[k] = 0.0f;
        if (bit[k] < n) {
          const float old = (it > 1) ? c2v[(size_t)(i * dc + k) * sB + b] : 0.0f;
          v[k] = llr[(size_t)bit[k] * sB + b] - old;
        }
      }
      float out[CAP];
      if (min_sum) {
        float a[CAP];
        int neg[CAP];
        int negsum = 0;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          const bool on = bit[k] < n;
          a[k] = on ? fabsf(v[k]) : kBig;
          neg[k] = (on && v[k] <= 0.0f) ? 1 : 0;
          negsum += neg[k];
        }
        // first-occurrence argmin over the dc slots, then the minimum of
        // the other slots (kBig when there are none)
        float min1 = a[0];
        int amin = 0;
#pragma unroll
        for (int k = 1; k < CAP; ++k) {
          if (k < dc && a[k] < min1) {
            min1 = a[k];
            amin = k;
          }
        }
        float min2 = kBig;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          if (k < dc && k != amin && a[k] < min2) min2 = a[k];
        }
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          const float excl = (k == amin) ? min2 : min1;
          const int par = (s + negsum + neg[k]) & 1;
          // alpha * sign * excl with sign = +-1: the product rounds once
          const float r = __fmul_rn(alpha, excl);
          out[k] = par ? -r : r;
        }
      } else {
        float t[CAP];
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          t[k] = (bit[k] < n) ? tanhf(__fmul_rn(v[k], 0.5f)) : 1.0f;
        }
        float pre[CAP], suf[CAP];
        float acc = 1.0f;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          pre[k] = acc;
          if (k < dc) acc = __fmul_rn(acc, t[k]);
        }
        acc = 1.0f;
#pragma unroll
        for (int k = CAP - 1; k >= 0; --k) {
          suf[k] = acc;
          if (k < dc) acc = __fmul_rn(acc, t[k]);
        }
        const float lo = -1.0f + 1e-7f, hi = 1.0f - 1e-7f;
        const float sgn = s ? -1.0f : 1.0f;
#pragma unroll
        for (int k = 0; k < CAP; ++k) {
          const float p = fminf(fmaxf(__fmul_rn(pre[k], suf[k]), lo), hi);
          const float mag = logf(__fdiv_rn(__fadd_rn(1.0f, p), __fsub_rn(1.0f, p)));
          out[k] = __fmul_rn(sgn, mag);
        }
      }
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        if (bit[k] < n) c2v[(size_t)(i * dc + k) * sB + b] = out[k];
      }
    }

    // ---- bit update and hard decision ----------------------------------
    for (int j = 0; j < n; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < dv; ++k) {
        const int e = __ldg(var_edges + j * dv + k);
        const float val = (e < E) ? c2v[(size_t)e * sB + b] : 0.0f;
        acc = (k == 0) ? val : __fadd_rn(acc, val);
      }
      const float l = __fadd_rn(__ldg(llr0 + j), acc);
      llr[j * sB + b] = l;
      dec[j * sB + b] = (l <= 0.0f) ? 1 : 0;
    }

    // ---- syndrome test on the new decisions ----------------------------
    bool ok = true;
    for (int i = 0; i < m && ok; ++i) {
      int par = synd[i * sB + b];
      for (int k = 0; k < dc; ++k) {
        const int j = __ldg(chk_bits + i * dc + k);
        if (j < n) par ^= dec[(size_t)j * sB + b];
      }
      ok = (par == 0);
    }
    converged = ok;
  }
  conv[b] = converged;
  iters[b] = it;
}

template <int CAP>
void launch(const uint8_t* synd, const float* llr0, const int* chk_bits,
            const int* var_edges, int m, int n, int dc, int dv, int B,
            int max_iter, int min_sum, float ms_scaling, float* c2v,
            float* llr, uint8_t* dec, bool* conv, int* iters,
            cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  bp_parallel_kernel<CAP><<<blocks, threads, 0, stream>>>(
      synd, llr0, chk_bits, var_edges, m, n, dc, dv, B, max_iter, min_sum,
      ms_scaling, c2v, llr, dec, conv, iters);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// checks dc <= 32 and allocates every buffer; nothing synchronises.
int ldpc_bp_parallel(const void* synd, const void* llr0, const void* chk_bits,
                     const void* var_edges, int m, int n, int dc, int dv,
                     int B, int max_iter, int min_sum, float ms_scaling,
                     void* c2v, void* llr, void* dec, void* conv, void* iters,
                     void* stream) {
  auto s = static_cast<const uint8_t*>(synd);
  auto l0 = static_cast<const float*>(llr0);
  auto cb = static_cast<const int*>(chk_bits);
  auto ve = static_cast<const int*>(var_edges);
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(c2v);
  auto l = static_cast<float*>(llr);
  auto d = static_cast<uint8_t*>(dec);
  auto cv = static_cast<bool*>(conv);
  auto itr = static_cast<int*>(iters);
  if (dc <= 4) {
    launch<4>(s, l0, cb, ve, m, n, dc, dv, B, max_iter, min_sum, ms_scaling, c, l, d, cv, itr, st);
  } else if (dc <= 8) {
    launch<8>(s, l0, cb, ve, m, n, dc, dv, B, max_iter, min_sum, ms_scaling, c, l, d, cv, itr, st);
  } else if (dc <= 16) {
    launch<16>(s, l0, cb, ve, m, n, dc, dv, B, max_iter, min_sum, ms_scaling, c, l, d, cv, itr, st);
  } else if (dc <= 32) {
    launch<32>(s, l0, cb, ve, m, n, dc, dv, B, max_iter, min_sum, ms_scaling, c, l, d, cv, itr, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* ldpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
