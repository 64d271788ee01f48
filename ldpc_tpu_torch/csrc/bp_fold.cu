// K6', K7': the serial fold-exact BP engines for Hopper (sm_90a), on one
// template. K8', the parallel fold-exact engine, has a kernel of its own in
// csrc/bp_exact.cu.
//
// Neither replaces a Pallas kernel: each is an XLA loop of the JAX package,
// written here by hand because in PyTorch its sequential steps would be
// thousands of launches a call (n bits x iterations x some 30 ops).
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
// Each computes what its plain PyTorch version in ldpc_tpu_torch/ops/bp_fold.py
// computes, the reference's steps:
//   - a bit's posterior is the channel LLR plus its c2v messages in slot order
//     (a left fold), and its message into slot k is the fold of the slots
//     before k plus the reverse fold of the slots after it, from the last down
//     (bp.hpp:277-318, 500-535);
//   - min-sum: the minimum |message| of a check's other slots, absent ones
//     counting 1e30, signed by the parity of the others' signs (v <= 0 counts
//     negative) and the syndrome, scaled by alpha (fixed, or 1 - 2^-it when
//     the factor is 0; K7' always fixed);
//   - product-sum: the product of tanh(v/2) over the other slots in row order,
//     clipped to +-(1 - 1e-7) in float32 only, then log((1+p)/(1-p)) signed
//     by the syndrome bit;
//   - a lane converges when the parity of its hard decisions equals its
//     (K7': current) syndrome, tested after each iteration, and stops there.
// Every sum and product is taken by one thread in that order and the build
// uses -fmad=false, so min-sum is bit-identical to the plain version.
//
// The level schedule of K6' and K7'. In a serial sweep bit j reads only the
// rows of its own checks and writes only its own edges there, its posterior
// and decision (K7': the soft and hard syndrome of its own checks). Two bits
// that share no check therefore commute, and a sweep in order o equals the
// sweep of its levels in turn, the bits of a level in any order: level(o[i])
// = 1 + the highest level of an earlier bit of o sharing a check with it.
// Surface d=13 in index order has 25 levels of at most 24 bits instead of
// 313 steps. ops/bp_fold.py::serial_levels is the plain model; fixed orders
// and each row of a random-serial table get their levels on the host
// (lv_bits, lv_ptr: a CSR, level l of a row spanning [ptr[l-1], ptr[l])),
// serial-relative builds its own each iteration (below).
//
// What bounds K6'/K7' on the H100: the latency of a lane's chain of levels,
// not bytes or operations. A lane runs levels x iterations dependent steps;
// the lanes BP fails run all max_iter sweeps (at d=13, 68% of the
// lane-iterations). A step costs two warp syncs and, per 32 of the level's
// (bit, slot) pairs, one row read (dc slots) and one fold (dv values) a
// thread: wide levels fill the warp's issue slots, narrow ones leave them
// idle. Serial-relative adds a sort of the lane's posteriors and a pass over
// its order for the levels, n dependent steps of a few instructions each. A
// lane's compulsory traffic is its syndrome in and its (n,) posteriors and
// decisions out.
//
// What the design does about it:
//   - A step takes a whole level: thread p of the warp computes the c2v value
//     of the level's (bit, slot) pair p from its check's row into a per-lane
//     scratch (kChunkPairs pairs, whole bits; a wider level takes several
//     chunks), then, after a warp sync, folds pair p's message; the thread of
//     slot 0 writes the bit's posterior and decision. K7''s virtual-update
//     rules run in the same thread: check c belongs to one bit of a level.
//   - Serial-relative: the lane's (key, index) pairs are sorted by a bitonic
//     network in its state (the key maps -post monotonically to an unsigned
//     integer, +-0 equal, NaN above every number, pads above NaN; the index
//     breaks ties, so the order is torch.argsort(-post, stable=True); in
//     float32 key and index share one 64-bit word). The levels pass walks
//     the order once with a per-check "last level" array: 32 positions' checks
//     are loaded at once and shuffled to every thread, which all take the
//     chain in lockstep, so a step is one shared-memory load and store. The
//     bits are bucketed by level with a counting sort (__match_any_sync ranks
//     a round's equal levels, so a level keeps order position and no atomics).
//   - K6' and K7' start pad slots at 1e30, so min-sum reads a check's row
//     without a pad test.
//   - One warp per lane and one lane a block, no block barrier: a converged
//     lane leaves at once and its block's shared memory and registers come
//     free for the next lane, so the long sweeps of the lanes BP fails do not
//     hold finished lanes' slots (it beat 2 and 4 lanes a block on the H100;
//     see PERF.md).
//   - A lane's state (messages m*dc, posteriors n, decisions n, syndrome m;
//     K7' its soft syndrome m; serial-relative its sort, level and bucket
//     arrays) lives in shared memory while it fits kLaneBudget, otherwise in
//     a lane-major scratch in device memory (same template, still one warp
//     per lane), so no code is refused for its size; the c2v chunk stays in
//     shared memory. ldpc_bp_fold_shared_state tells the wrapper which.
//   - The graph arrays and the host's levels are read through __ldg: every
//     warp of an SM reads the same few KB, which stay in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// A lane's state lives in shared memory up to this many bytes (K1''s budget:
// 9 lanes at the budget fit an SM).
constexpr size_t kLaneBudget = 24 * 1024;
// (bit, slot) pairs of a level that one step of the sweep takes at most,
// whole bits (a bit of more slots takes a step alone)
constexpr int kChunkPairs = 128;

// engine numbers of ldpc_bp_fold_shared_state (2: K8', csrc/bp_exact.cu)
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

// The serial-relative sort key of a posterior: -post mapped monotonically to
// an unsigned integer of its width, +0 and -0 equal, every NaN above every
// number (all-ones; the pads' index breaks the tie).
__device__ __forceinline__ uint32_t order_key(float post) {
  const uint32_t u = __float_as_uint(post) ^ 0x80000000u;  // -post, exactly
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if ((u & 0x7fffffffu) == 0) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long order_key(double post) {
  const unsigned long long sign = 1ull << 63;
  const unsigned long long u = (unsigned long long)__double_as_longlong(post) ^ sign;
  if ((u & ~sign) > 0x7ff0000000000000ull) return ~0ull;
  if ((u & ~sign) == 0) return sign;
  return (u & sign) ? ~u : (u | sign);
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}
__host__ __device__ inline int chunk_bits(int dv) {
  return dv >= kChunkPairs ? 1 : kChunkPairs / (dv > 0 ? dv : 1);
}
__host__ __device__ inline int chunk_pairs(int dv) { return chunk_bits(dv) * (dv > 0 ? dv : 1); }

// Byte offsets of serial-relative's arrays in a lane's piece of memory: the
// sort's words (a power of two >= n of them; the level of each order
// position once sorted), the indices (the order), the bits bucketed by
// level, and the per-check last level (m; then the level pointers, L + 1 <=
// n + 1).
struct RelLayout {
  size_t key, sidx, lbits, lcur, total;
};

__host__ __device__ inline RelLayout relative_layout(int m, int n) {
  RelLayout R{};
  const size_t P = (size_t)pow2_at_least(n);
  size_t off = 0;
  R.key = off;
  off += align16(P * 8);  // float32: key and index in a word; float64: the key
  R.sidx = off;
  off += align16(P * sizeof(int));
  R.lbits = off;
  off += align16((size_t)n * sizeof(int));
  R.lcur = off;
  off += align16((size_t)(m > n + 1 ? m : n + 1) * sizeof(int));
  R.total = off;
  return R;
}

// Byte offsets of a lane's pieces in shared memory, each 16-aligned: its whole
// state in the shared variant; in the device variant only the c2v chunk of
// the level in hand, the rest lives in device memory.
struct Layout {
  size_t msg, post, hard, synd, soft, rel, c2v, total;
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
      L.rel = off;
      off += relative_layout(m, n).total;
    }
  }
  L.c2v = off;
  off += align16((size_t)chunk_pairs(dv) * elem);
  L.total = off;
  return L;
}

template <typename T>
struct FoldArgs {
  const uint8_t* synd;     // (B, m) 0/1 syndromes (K6')
  const T* soft_in;        // (B, m) scaled soft syndromes (K7')
  const T* llr0;           // (n,) channel LLRs
  // chk_bits (m, dc) check-major, var_edges (n, dv) ids c*dc+slot and
  // var_chks (n, dv). pad: chk_bits n, var_edges m*dc, var_chks m; a row's
  // and a column's slots are filled first, pads last
  const int* chk_bits;
  const int* var_edges;
  const int* var_chks;
  // K6' fixed and table orders, K7': the levels, one row per order (row it-1
  // of a table in iteration it): lv_bits (R, n), lv_ptr (R, n+1)
  const int* lv_bits;
  const int* lv_ptr;
  int m, n, dc, dv, B, max_iter, order_mode;
  T ms_scaling, cutoff;
  // device variant: lane-major scratch
  T* msg;                  // (B, m*dc) messages
  unsigned char* rel;      // (B, rel_bytes) serial-relative's arrays
  size_t rel_bytes;
  uint8_t* synd_work;      // (B, m) K7''s hard syndrome
  // outputs
  T* post;                 // (B, n)
  uint8_t* dec;            // (B, n)
  T* soft_out;             // (B, m) K7'
  bool* conv;              // (B,)
  int* iters;              // (B,)
  // optional (B, 5): clock64 cycles in the sort, in the levels pass and
  // bucketing, in the sweeps; levels swept in all, most in one sweep
  long long* prof;
};

// Thread t's walk over a chunk's (bit, slot) pairs t, t+32, ...: its first
// pair as bit bi0 and slot k0, the step of 32 pairs (dbi bits, dk slots) and
// the chunk's bits, divided out once in the kernel's prologue.
struct PairWalk {
  int bi0, k0, dbi, dk, cb;
  __device__ __forceinline__ PairWalk(int t, int dv)
      : bi0(t / dv), k0(t % dv), dbi(32 / dv), dk(32 % dv), cb(chunk_bits(dv)) {}
  __device__ __forceinline__ void next(int dv, int& bi, int& k) const {
    bi += dbi;
    k += dk;
    if (k >= dv) {
      k -= dv;
      ++bi;
    }
  }
};

// One level of a serial sweep (K6' and, kSoft, K7'): ``width`` bits that
// share no check, bits[0..width) (through __ldg when ``ro``). Per chunk of
// whole bits: the c2v of each (bit, slot) pair from its check's row, then
// each pair's message and each bit's posterior and decision.
template <typename T, bool kMinSum, bool kSoft>
__device__ __forceinline__ void sweep_level(const FoldArgs<T>& a, const PairWalk& walk,
                                            const int* bits, int width, bool ro, int t, T alpha,
                                            T* msg, T* c2v, T* post, uint8_t* hard, uint8_t* syn,
                                            T* soft) {
  const int n = a.n, dc = a.dc, dv = a.dv, E = a.m * dc;
  const int cb = walk.cb;
  for (int b0 = 0; b0 < width; b0 += cb) {
    const int pairs = (width - b0 < cb ? width - b0 : cb) * dv;
    int bi = walk.bi0, k = walk.k0;
    for (int p = t; p < pairs; p += 32, walk.next(dv, bi, k)) {
      const int j = ro ? __ldg(bits + b0 + bi) : bits[b0 + bi];
      const int e = __ldg(a.var_edges + j * dv + k);
      if (e >= E) continue;
      const int c = __ldg(a.var_chks + j * dv + k);
      const int own = e - c * dc;
      const int* row_bits = a.chk_bits + c * dc;
      const T* row = msg + c * dc;
      T v;
      if (kMinSum) {
        T temp = big<T>();
        int negs = 0;
        for (int s = 0; s < dc; ++s) {
          if (s == own) continue;
          const T x = row[s];  // a pad slot's 1e30 changes nothing
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
          soft[c] = ss_new;  // check c is this thread's alone in the level
          syn[c] = (uint8_t)s_new;
          const T r = alpha * prop;
          v = ((negs + s_new) & 1) ? -r : r;
        } else {
          const T r = alpha * temp;
          v = ((syn[c] + negs) & 1) ? -r : r;
        }
      } else {
        T prod = T(1);
        for (int s = 0; s < dc; ++s) {
          if (s == own || __ldg(row_bits + s) >= n) continue;
          prod = prod * tanh_(row[s] * T(0.5));
        }
        prod = clip_(prod);
        const T mag = log_((T(1) + prod) / (T(1) - prod));
        v = syn[c] ? -mag : mag;
      }
      c2v[p] = v;
    }
    __syncwarp();
    bi = walk.bi0;
    k = walk.k0;
    for (int p = t; p < pairs; p += 32, walk.next(dv, bi, k)) {
      const int j = ro ? __ldg(bits + b0 + bi) : bits[b0 + bi];
      const int* edges = a.var_edges + j * dv;
      const int e = __ldg(edges + k);
      const bool edge = e < E;
      if (!edge && k > 0) continue;  // slot 0 of a bit in no check still writes
      const T* cv = c2v + bi * dv;
      int deg = k + edge;  // the bit's slots are filled first, pads last
      if (edge) {
        while (deg < dv && __ldg(edges + deg) < E) ++deg;
      }
      const T l0 = __ldg(a.llr0 + j);
      if (edge) {
        T part = l0;  // channel + the slots before k, left fold
        for (int q = 0; q < k; ++q) part = part + cv[q];
        T suf = T(0);  // the slots after k, from the last down
        for (int q = deg - 1; q > k; --q) suf = suf + cv[q];
        msg[e] = part + suf;
      }
      if (k == 0) {
        T l = l0;
        for (int q = 0; q < deg; ++q) l = l + cv[q];
        post[j] = l;
        hard[j] = l <= T(0);
      }
    }
    __syncwarp();
  }
}

// The bitonic network over P (a power of two) elements of ``w`` (and ``idx``
// when given): ascending, a pair ordered by its word and then its index.
template <typename W>
__device__ __forceinline__ void bitonic_sort(W* w, int* idx, int P, int t) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < P / 2; i += 32) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo | j;
        const W wa = w[lo], wb = w[hi];
        const int ia = idx ? idx[lo] : 0, ib = idx ? idx[hi] : 0;
        const bool greater = wa > wb || (wa == wb && ia > ib);
        if (greater == ((lo & k) == 0)) {  // ascending where bit k of lo is 0
          w[lo] = wb;
          w[hi] = wa;
          if (idx) {
            idx[lo] = ib;
            idx[hi] = ia;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Each position's level for column degree <= S: a round's 32 positions load
// their checks at once, the shuffles hand position i's to every thread,
// which all walk the chain in lockstep and write the same levels, so each
// reads its own writes and only the last levels' load and store stay on the
// chain. Returns the number of levels (in every thread).
template <int S>
__device__ __forceinline__ int levels_pass(const int* var_chks, int m, int n, int dv, int t,
                                           const int* sidx, int* last, int* lvl) {
  int nlev = 0;
  for (int base = 0; base < n; base += 32) {
    const int idx = base + t;
    const int* chks = var_chks + (size_t)(idx < n ? sidx[idx] : 0) * dv;
    int ch[S];
#pragma unroll
    for (int k = 0; k < S; ++k) ch[k] = idx < n && k < dv ? __ldg(chks + k) : m;
    const int steps = n - base < 32 ? n - base : 32;
    int mine = 0;
    for (int i = 0; i < steps; ++i) {
      int c[S];
#pragma unroll
      for (int k = 0; k < S; ++k) c[k] = __shfl_sync(kFull, ch[k], i);
      int lv = 0;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (c[k] < m) lv = last[c[k]] > lv ? last[c[k]] : lv;
      }
      ++lv;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (c[k] < m) last[c[k]] = lv;
      }
      mine = t == i ? lv : mine;
    }
    if (idx < n) lvl[idx] = mine;
    nlev = mine > nlev ? mine : nlev;
  }
  return __reduce_max_sync(kFull, nlev);
}

// Serial-relative's levels of one iteration, from the lane's posteriors:
// the order torch.argsort(-post, stable=True) by a bitonic network (float32:
// key and index in one 64-bit word; float64: a key and an index), each
// position's level in one pass over the order, then the bits bucketed by
// level in order position. Leaves the bits in lbits and level l's end in
// lcur[l] (lcur[0] = 0), so level l spans [lcur[l-1], lcur[l]).
template <typename T>
__device__ __forceinline__ void relative_levels(const FoldArgs<T>& a, int t, const T* post,
                                                unsigned char* rel, long long* cycles) {
  const int n = a.n, m = a.m, dv = a.dv;
  const RelLayout R = relative_layout(m, n);
  int* sidx = reinterpret_cast<int*>(rel + R.sidx);
  int* lbits = reinterpret_cast<int*>(rel + R.lbits);
  int* lcur = reinterpret_cast<int*>(rel + R.lcur);
  const int P = pow2_at_least(n);
  long long t0 = cycles ? clock64() : 0;
  if constexpr (sizeof(T) == 4) {
    unsigned long long* w = reinterpret_cast<unsigned long long*>(rel + R.key);
    for (int i = t; i < P; i += 32) {  // pads: the all-ones key, after every NaN
      const unsigned long long key = i < n ? order_key(post[i]) : 0xffffffffu;
      w[i] = key << 32 | (unsigned)i;
    }
    __syncwarp();
    bitonic_sort(w, static_cast<int*>(nullptr), P, t);
    for (int i = t; i < n; i += 32) sidx[i] = (int)(w[i] & 0xffffffffu);
  } else {
    unsigned long long* key = reinterpret_cast<unsigned long long*>(rel + R.key);
    for (int i = t; i < P; i += 32) {
      key[i] = i < n ? order_key(post[i]) : ~0ull;
      sidx[i] = i;
    }
    __syncwarp();
    bitonic_sort(key, sidx, P, t);
  }
  __syncwarp();
  if (cycles) {
    const long long t1 = clock64();
    cycles[0] += t1 - t0;
    t0 = t1;
  }
  // each order position's level: 1 + the highest level of an earlier bit in
  // one of its checks (the sort's words are spent: their room holds the
  // levels)
  int* lvl = reinterpret_cast<int*>(rel + R.key);
  int* last = lcur;
  for (int c = t; c < m; c += 32) last[c] = 0;
  __syncwarp();
  int nlev = 0;
  if (dv <= 2) {
    nlev = levels_pass<2>(a.var_chks, m, n, dv, t, sidx, last, lvl);
  } else if (dv <= 4) {
    nlev = levels_pass<4>(a.var_chks, m, n, dv, t, sidx, last, lvl);
  } else {
    if (t == 0) {  // wider columns: thread 0 walks the order alone
      for (int idx = 0; idx < n; ++idx) {
        const int* chks = a.var_chks + (size_t)sidx[idx] * dv;
        int lv = 0;
        for (int k = 0; k < dv; ++k) {
          const int c = __ldg(chks + k);
          if (c >= m) break;
          lv = last[c] > lv ? last[c] : lv;
        }
        ++lv;
        for (int k = 0; k < dv; ++k) {
          const int c = __ldg(chks + k);
          if (c >= m) break;
          last[c] = lv;
        }
        lvl[idx] = lv;
        nlev = lv > nlev ? lv : nlev;
      }
    }
    nlev = __shfl_sync(kFull, nlev, 0);
  }
  __syncwarp();
  // counting sort by level: counts, starts, then each round's bits at their
  // level's cursor, ranked among the round's equal levels (order kept)
  for (int l = t; l <= nlev; l += 32) lcur[l] = 0;
  __syncwarp();
  const unsigned below = (1u << t) - 1u;
  for (int base = 0; base < n; base += 32) {
    const int idx = base + t;
    const int lv = idx < n ? lvl[idx] : 0;
    const unsigned peers = __match_any_sync(kFull, lv);
    if (idx < n && (peers & below) == 0) lcur[lv] += __popc(peers);
    __syncwarp();
  }
  if (t == 0) {
    int run = 0;
    for (int l = 0; l <= nlev; ++l) {
      const int c = lcur[l];
      lcur[l] = run;
      run += c;
    }
  }
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const int idx = base + t;
    const int lv = idx < n ? lvl[idx] : 0;
    const unsigned peers = __match_any_sync(kFull, lv);
    const int rank = __popc(peers & below);
    if (idx < n) lbits[lcur[lv] + rank] = sidx[idx];
    __syncwarp();
    if (idx < n && rank == 0) lcur[lv] += __popc(peers);
    __syncwarp();
  }
  if (cycles) cycles[1] += clock64() - t0;
}

template <typename T, int kEngine, bool kMinSum, bool kShared>
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
  unsigned char* rel = nullptr;
  if (kShared) {
    msg = reinterpret_cast<T*>(base + L.msg);
    post = reinterpret_cast<T*>(base + L.post);
    hard = base + L.hard;
    syn = base + L.synd;
    if (kEngine == kSoftInfo) soft = reinterpret_cast<T*>(base + L.soft);
    if (relative) rel = base + L.rel;
    if (kEngine != kSoftInfo) {
      const uint8_t* src = a.synd + (size_t)b * m;
      for (int i = t; i < m; i += 32) syn[i] = src[i];
    }
  } else {
    msg = a.msg + (size_t)b * E;
    post = a.post + (size_t)b * n;
    hard = a.dec + (size_t)b * n;
    // K6' only reads the syndrome: the input serves
    syn = kEngine == kSoftInfo ? a.synd_work + (size_t)b * m
                               : const_cast<uint8_t*>(a.synd + (size_t)b * m);
    if (kEngine == kSoftInfo) soft = a.soft_out + (size_t)b * m;
    if (relative) rel = a.rel + (size_t)b * a.rel_bytes;
  }
  if (kEngine == kSoftInfo) {
    const T* src = a.soft_in + (size_t)b * m;
    for (int i = t; i < m; i += 32) {
      const T s = src[i];
      soft[i] = s;
      syn[i] = s <= T(0);
    }
  }
  // bit-to-check messages start at the channel LLR of the edge's bit; pad
  // slots hold 1e30, which min-sum can read as a message (no smaller
  // magnitude, not negative)
  for (int e = t; e < E; e += 32) {
    const int j = __ldg(a.chk_bits + e);
    msg[e] = j < n ? __ldg(a.llr0 + j) : big<T>();
  }
  for (int j = t; j < n; j += 32) {
    post[j] = __ldg(a.llr0 + j);
    hard[j] = 0;
  }
  __syncwarp();

  const PairWalk walk(t, a.dv > 0 ? a.dv : 1);
  long long cycles[3] = {0, 0, 0};
  long long* prof = a.prof != nullptr && t == 0 ? cycles : nullptr;
  int levels_swept = 0, levels_most = 0;
  bool converged = false;
  int it = 0;
  while (it < a.max_iter) {
    ++it;
    const T alpha = (kMinSum && kEngine != kSoftInfo && a.ms_scaling == T(0))
                        ? dynamic_alpha(T(0), it)
                        : a.ms_scaling;
    {
      const int* bits;
      const int* ptr;
      if (relative) {
        relative_levels(a, t, post, rel, prof);
        const RelLayout R = relative_layout(m, n);
        bits = reinterpret_cast<const int*>(rel + R.lbits);
        ptr = reinterpret_cast<const int*>(rel + R.lcur);
      } else {
        const size_t row = a.order_mode == kOrderTable ? (size_t)(it - 1) : 0;
        bits = a.lv_bits + row * n;
        ptr = a.lv_ptr + row * (n + 1);
      }
      const long long s0 = prof ? clock64() : 0;
      int lo = 0, nlev = 0;
      for (int l = 1; lo < n; ++l, ++nlev) {
        const int hi = relative ? ptr[l] : __ldg(ptr + l);
        sweep_level<T, kMinSum, kEngine == kSoftInfo>(a, walk, bits + lo, hi - lo, !relative,
                                                      t, alpha, msg, c2v, post, hard, syn, soft);
        lo = hi;
      }
      if (prof) cycles[2] += clock64() - s0;
      levels_swept += nlev;
      levels_most = nlev > levels_most ? nlev : levels_most;
    }
    // syndrome test on the new decisions
    bool ok = true;
    for (int i = t; i < m && ok; i += 32) {
      int par = syn[i];
      for (int k = 0; k < dc; ++k) {
        const int j = __ldg(a.chk_bits + (size_t)i * dc + k);
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
    if (prof) {
      long long* out = a.prof + (size_t)b * 5;
      out[0] = cycles[0];
      out[1] = cycles[1];
      out[2] = cycles[2];
      out[3] = levels_swept;
      out[4] = levels_most;
    }
  }
}

template <typename T, int kEngine, bool kMinSum, bool kShared>
int launch(const FoldArgs<T>& a, cudaStream_t stream) {
  auto kernel = fold_kernel<T, kEngine, kMinSum, kShared>;
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

template <typename T, int kEngine, bool kMinSum>
int launch_state(const FoldArgs<T>& a, int shared, cudaStream_t st) {
  return shared ? launch<T, kEngine, kMinSum, true>(a, st)
                : launch<T, kEngine, kMinSum, false>(a, st);
}

template <typename T>
FoldArgs<T> make_args(const void* synd, const void* soft_in, const void* llr0,
                      const void* chk_bits, const void* var_edges, const void* var_chks,
                      const void* lv_bits, const void* lv_ptr, int m, int n, int dc, int dv,
                      int B, int max_iter, int order_mode, double ms_scaling, double cutoff,
                      void* msg, void* rel, void* synd_work, void* post, void* dec,
                      void* soft_out, void* conv, void* iters, void* prof) {
  FoldArgs<T> a;
  a.synd = static_cast<const uint8_t*>(synd);
  a.soft_in = static_cast<const T*>(soft_in);
  a.llr0 = static_cast<const T*>(llr0);
  a.chk_bits = static_cast<const int*>(chk_bits);
  a.var_edges = static_cast<const int*>(var_edges);
  a.var_chks = static_cast<const int*>(var_chks);
  a.lv_bits = static_cast<const int*>(lv_bits);
  a.lv_ptr = static_cast<const int*>(lv_ptr);
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
  a.rel = static_cast<unsigned char*>(rel);
  a.rel_bytes = relative_layout(m, n).total;
  a.synd_work = static_cast<uint8_t*>(synd_work);
  a.post = static_cast<T*>(post);
  a.dec = static_cast<uint8_t*>(dec);
  a.soft_out = static_cast<T*>(soft_out);
  a.conv = static_cast<bool*>(conv);
  a.iters = static_cast<int*>(iters);
  a.prof = static_cast<long long*>(prof);
  return a;
}

template <typename T>
int serial_dispatch(const FoldArgs<T>& a, int min_sum, int shared, cudaStream_t st) {
  return min_sum ? launch_state<T, kSerial, true>(a, shared, st)
                 : launch_state<T, kSerial, false>(a, shared, st);
}

}  // namespace

extern "C" {

int ldpc_bp_exact_shared_state(int m, int n, int dc);  // csrc/bp_exact.cu

// 1 when a lane of engine (0 K6', 1 K7', 2 K8') on an (m, n, dc, dv) code in
// elements of elem bytes fits its kernel's per-lane budget, so the
// shared-memory variant is the default; 0 for the device-memory variant.
// K8' (float64 only) answers from its own layout.
int ldpc_bp_fold_shared_state(int engine, int m, int n, int dc, int dv, int elem,
                              int relative) {
  if (engine == kExact) return ldpc_bp_exact_shared_state(m, n, dc);
  return lane_layout(engine, m, n, dc, dv, elem, relative != 0, true).total <= kLaneBudget;
}

// Bytes of a lane's serial-relative arrays (K6''s device variant takes a
// (B, this) scratch).
int ldpc_bp_serial_relative_bytes(int m, int n) { return (int)relative_layout(m, n).total; }

// K6'. lv_bits (R, n) and lv_ptr (R, n+1) int32: the levels of the order,
// R = 1 for order_mode 0, one row per iteration for 1; unused for 2. f64
// selects double for llr0, post and msg. The device variant (shared == 0)
// reads msg (B, m*dc) and, serial-relative, rel (B,
// ldpc_bp_serial_relative_bytes). prof: null, or (B, 5) int64. Returns
// cudaGetLastError() after the launch (0 on success) or the error of raising
// the block's shared-memory limit. Nothing synchronises.
int ldpc_bp_serial(const void* synd, const void* llr0, const void* chk_bits,
                   const void* var_edges, const void* var_chks, const void* lv_bits,
                   const void* lv_ptr, int m, int n, int dc, int dv, int B, int max_iter,
                   int order_mode, int min_sum, int f64, double ms_scaling, int shared,
                   void* msg, void* rel, void* post, void* dec, void* conv, void* iters,
                   void* prof, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return serial_dispatch(
        make_args<double>(synd, nullptr, llr0, chk_bits, var_edges, var_chks, lv_bits, lv_ptr,
                          m, n, dc, dv, B, max_iter, order_mode, ms_scaling, 0.0, msg, rel,
                          nullptr, post, dec, nullptr, conv, iters, prof),
        min_sum, shared, st);
  }
  return serial_dispatch(
      make_args<float>(synd, nullptr, llr0, chk_bits, var_edges, var_chks, lv_bits, lv_ptr, m,
                       n, dc, dv, B, max_iter, order_mode, ms_scaling, 0.0, msg, rel, nullptr,
                       post, dec, nullptr, conv, iters, prof),
      min_sum, shared, st);
}

// K7' (min-sum). soft_in: (B, m) soft syndromes already scaled by 2/sigma^2,
// in the engine's type; lv_bits (1, n), lv_ptr (1, n+1): the levels of index
// order; soft_out (B, m) receives the final soft syndrome. The device variant
// reads msg (B, m*dc) and synd (B, m) uint8 scratch. prof as for K6'.
int ldpc_bp_soft_info(const void* soft_in, const void* llr0, const void* chk_bits,
                      const void* var_edges, const void* var_chks, const void* lv_bits,
                      const void* lv_ptr, int m, int n, int dc, int dv, int B, int max_iter,
                      int f64, double ms_scaling, double cutoff, int shared, void* msg,
                      void* synd, void* post, void* dec, void* soft_out, void* conv,
                      void* iters, void* prof, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return launch_state<double, kSoftInfo, true>(
        make_args<double>(nullptr, soft_in, llr0, chk_bits, var_edges, var_chks, lv_bits,
                          lv_ptr, m, n, dc, dv, B, max_iter, kOrderFixed, ms_scaling, cutoff,
                          msg, nullptr, synd, post, dec, soft_out, conv, iters, prof),
        shared, st);
  }
  return launch_state<float, kSoftInfo, true>(
      make_args<float>(nullptr, soft_in, llr0, chk_bits, var_edges, var_chks, lv_bits, lv_ptr,
                       m, n, dc, dv, B, max_iter, kOrderFixed, ms_scaling, cutoff, msg, nullptr,
                       synd, post, dec, soft_out, conv, iters, prof),
      shared, st);
}

}  // extern "C"
