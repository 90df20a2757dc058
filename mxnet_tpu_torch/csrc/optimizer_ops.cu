// Multi-tensor optimizer updates for Hopper (sm_90a): O1 multi_adamw,
// O2 multi_sgd and O3 multi_sum_sq.
//
// No Pallas kernel stands behind these.  The JAX package gets the fusion
// from XLA: gluon/trainer.py jits one update over the whole parameter
// list, and ops/optimizer_ops.py registers the multi-tensor ops this file
// serves: _multi_adamw_update (O1), multi_sgd_mom_update and the other
// SGD variants (O2), multi_sum_sq, all_finite and multi_all_finite (O3).
//
// Bound.  Every kernel here is bound by bytes: an adamw update reads w,
// g, m and v and writes w, m and v (14 bytes an element in bf16), SGD
// with momentum reads w, g and mom and writes w and mom, the sum of
// squares reads each element once.  So each element is touched once, in
// 16-byte vector loads where a tensor's address allows it, with all
// arithmetic in f32 registers and one rounding into each stored dtype.
//
// Design.
// - One launch covers a list of tensors of different sizes.  The table
//   of tensors (pointers, sizes, per-tensor factors, the first chunk of
//   each) is a kernel parameter passed by value (CUDA 12.1+ allows
//   32,764 bytes of them), so a captured graph holds it in its node and
//   nothing on the device outlives the launch.  A list longer than one
//   table takes more launches.  The host functions build the tables from
//   host arrays; nothing is copied to the device.
// - A block takes one chunk of kChunk elements of one tensor; it finds
//   its tensor by a binary search over the table's first-chunk column.
// - 16-byte vector loads where every operand of the tensor is 16-byte
//   aligned, eight elements a thread; a scalar loop otherwise and for the
//   ragged tail of a tensor.
// - lr and the update count are read by pointer from the device (the
//   class forms), so a captured step reads what the host wrote before
//   the replay.  beta^t is the f32 powf of the count cast to f32, as the
//   JAX package's jitted step forms it.
// - The arithmetic goes through the _rn intrinsics, which the compiler
//   never contracts, with a fused multiply-add exactly where the plain
//   PyTorch version takes one (torch's add with alpha, in SGD), so each
//   result is the one the plain version gives.
// - O3 uses no float atomics: each chunk writes its f64 partial sum and
//   its all-finite bit to a workspace, and a second kernel sums each
//   tensor's partials in chunk order (one block a tensor) and ANDs the
//   bits, so two runs are bitwise equal.
//
// dtype codes: 0 float32, 1 bfloat16, 2 float16.  Each entry point
// returns cudaGetLastError() (or kBadTypes for a dtype combination it
// has no kernel for), launches on the caller's stream and writes the
// number of kernels it launched to *launched.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                         // elements a thread a step
constexpr int kSteps = 4;                       // vector steps a chunk
constexpr int kChunk = kThreads * kVec * kSteps;  // 8192 elements a block
constexpr int kBadTypes = -1;

// -- conversions ------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded into T and back (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// eight consecutive elements through 16-byte words
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
  constexpr int kWords = sizeof(T) * kVec / 16;
  alignas(16) T x[kVec];
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    reinterpret_cast<uint4*>(x)[k] = reinterpret_cast<const uint4*>(p)[k];
#pragma unroll
  for (int k = 0; k < kVec; ++k) f[k] = to_f<T>(x[k]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* f) {
  constexpr int kWords = sizeof(T) * kVec / 16;
  alignas(16) T x[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) x[k] = from_f<T>(f[k]);
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    reinterpret_cast<uint4*>(p)[k] = reinterpret_cast<const uint4*>(x)[k];
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float clip(float g, float c) {
  // NaN passes through, as torch.clamp and jnp.clip give it
  return g < -c ? -c : (g > c ? c : g);
}

// the table entry holding chunk `c`: the last entry whose first chunk is
// at or before c (an empty tensor's entry shares its first chunk with
// the next one, so the search skips it)
template <typename Entry>
__device__ __forceinline__ int find_entry(const Entry* t, int count, int c) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// -- O1: multi_adamw ----------------------------------------------------------

struct AdamEntry {
  void* w;
  const void* g;
  void* m;
  void* v;
  float* w32;       // the f32 master weight (mp_ forms), else null
  long long n;
  float lr;         // a factor of *lr (class forms) or the rate (op forms)
  float wd;
  float eta;        // op forms' eta; 1 in the class forms
  int chunk0;
};

constexpr int kAdamCap = 448;   // 448 x 64 B = 28 KB of parameters

struct AdamArgs {
  const float* lr;          // device lr (class forms), else null
  const int* t;             // device update count (class forms), else null
  const float* rescale_p;   // device rescale_grad (_adamw_update), else null
  float rescale, clip, beta1, beta2, one_m_b1, one_m_b2, eps;
  int fold_wd;              // Adam: g += wd*w; AdamW: decoupled decay
  int count;
  AdamEntry e[kAdamCap];
};

// a block's coefficients, in registers
struct AdamCoef {
  float b1, b2, omb1, omb2, eps, a, d, eta, wd;
  bool fold;
};

// one element: w (f32 view), g, m, v in; m and v come back as stored
// (rounded into the state's dtype), w unrounded.  The denominator
// sqrt(v) + eps is formed in the state's dtype, as the JAX package forms
// it from its stored v (each of its two ops rounded there; exact in f32)
template <typename TS>
__device__ __forceinline__ void adam_elem(float& w, float g, float& m,
                                          float& v, const AdamCoef& c) {
  if (c.fold) g = __fadd_rn(g, __fmul_rn(c.wd, w));
  m = round_to<TS>(__fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g)));
  v = round_to<TS>(__fadd_rn(__fmul_rn(c.b2, v),
                             __fmul_rn(c.omb2, __fmul_rn(g, g))));
  const float den =
      round_to<TS>(__fadd_rn(round_to<TS>(__fsqrt_rn(v)), c.eps));
  const float upd =
      __fadd_rn(__fdiv_rn(__fmul_rn(c.a, m), den), __fmul_rn(c.d, w));
  w = __fsub_rn(w, __fmul_rn(c.eta, upd));
}

template <typename TW>
__device__ __forceinline__ float grad_in(float g, bool mp, float rescale,
                                         float c) {
  // outside the mp_ forms the gradient is first rounded into the
  // weight's dtype (the plain version's grad.to(weight.dtype))
  if (!mp) g = round_to<TW>(g);
  g = __fmul_rn(g, rescale);
  return c >= 0.f ? clip(g, c) : g;
}

template <typename TW, typename TG, typename TS, bool MP>
__global__ void __launch_bounds__(kThreads)
    multi_adamw_kernel(const __grid_constant__ AdamArgs p) {
  const int i = find_entry(p.e, p.count, blockIdx.x);
  TW* w = static_cast<TW*>(p.e[i].w);
  const TG* g = static_cast<const TG*>(p.e[i].g);
  TS* m = static_cast<TS*>(p.e[i].m);
  TS* v = static_cast<TS*>(p.e[i].v);
  float* w32 = p.e[i].w32;
  const long long n = p.e[i].n;
  AdamCoef c;
  c.b1 = p.beta1;
  c.b2 = p.beta2;
  c.omb1 = p.one_m_b1;
  c.omb2 = p.one_m_b2;
  c.eps = p.eps;
  c.wd = p.e[i].wd;
  c.eta = p.e[i].eta;
  c.fold = p.fold_wd != 0;
  float lr = p.e[i].lr;
  if (p.lr != nullptr) lr = __fmul_rn(*p.lr, lr);
  if (p.t != nullptr) {
    // class form: lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), all f32
    const float tf = static_cast<float>(*p.t);
    const float c2 = __fsub_rn(1.f, powf(c.b2, tf));
    const float c1 = __fsub_rn(1.f, powf(c.b1, tf));
    c.a = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(c2)), c1);
    c.d = c.fold ? 0.f : __fmul_rn(lr, c.wd);
  } else {
    c.a = lr;
    c.d = c.fold ? 0.f : c.wd;
  }
  const float rescale = p.rescale_p != nullptr ? *p.rescale_p : p.rescale;
  const float clip_at = p.clip;
  const long long start =
      static_cast<long long>(blockIdx.x - p.e[i].chunk0) * kChunk;
  const long long end = start + kChunk < n ? start + kChunk : n;
  const bool vec = aligned16(w) && aligned16(g) && aligned16(m) &&
                   aligned16(v) && (!MP || aligned16(w32));
  auto scalar = [&](long long j) {
    float wv = MP ? w32[j] : to_f<TW>(w[j]);
    float mv = to_f<TS>(m[j]), vv = to_f<TS>(v[j]);
    const float gv = grad_in<TW>(to_f<TG>(g[j]), MP, rescale, clip_at);
    adam_elem<TS>(wv, gv, mv, vv, c);
    m[j] = from_f<TS>(mv);
    v[j] = from_f<TS>(vv);
    w[j] = from_f<TW>(wv);
    if (MP) w32[j] = wv;
  };
  if (!vec) {
    for (long long j = start + threadIdx.x; j < end; j += kThreads) scalar(j);
    return;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long j0 = start + (static_cast<long long>(s) * kThreads +
                                  threadIdx.x) * kVec;
    if (j0 + kVec <= end) {
      float wv[kVec], gv[kVec], mv[kVec], vv[kVec];
      if (MP) load8<float>(w32 + j0, wv); else load8<TW>(w + j0, wv);
      load8<TG>(g + j0, gv);
      load8<TS>(m + j0, mv);
      load8<TS>(v + j0, vv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float gk = grad_in<TW>(gv[k], MP, rescale, clip_at);
        adam_elem<TS>(wv[k], gk, mv[k], vv[k], c);
      }
      store8<TS>(m + j0, mv);
      store8<TS>(v + j0, vv);
      store8<TW>(w + j0, wv);
      if (MP) store8<float>(w32 + j0, wv);
    } else {
      for (long long j = j0; j < end; ++j) scalar(j);
    }
  }
}

// -- O2: multi_sgd ------------------------------------------------------------

struct SgdEntry {
  void* w;
  const void* g;
  void* mom;        // null without momentum
  float* w32;       // the f32 master weight (mp_ forms), else null
  long long n;
  float lr;         // a factor of *lr, or the rate
  float wd;
  int chunk0;
  int pad;
};

constexpr int kSgdCap = 512;    // 512 x 56 B = 28 KB of parameters

struct SgdArgs {
  const float* lr;          // device lr (class forms), else null
  const float* lrs;         // per-tensor device rates (preloaded_ ops)
  const float* wds;         // per-tensor device decays (preloaded_ ops)
  float rescale, clip, momentum;
  int kind;                 // 0 plain, 1 momentum, 2 Nesterov momentum
  int count;
  SgdEntry e[kSgdCap];
};

// one element: the new weight from the unrounded f32 momentum, the
// momentum as stored.  Each a*x + y is one fused multiply-add, as torch's
// add(y, x, alpha=a) forms it in the plain version and XLA in the JAX
// package's step (bf16 SGD agrees with it bit for bit that way)
template <typename TS>
__device__ __forceinline__ void sgd_elem(float& w, float g, float& mom,
                                         float lr, float wd, float mu,
                                         int kind) {
  const float gd = __fmaf_rn(wd, w, g);
  if (kind == 0) {
    w = __fmaf_rn(-lr, gd, w);
  } else if (kind == 1) {
    const float nm = __fmaf_rn(-lr, gd, __fmul_rn(mu, mom));
    w = __fadd_rn(w, nm);
    mom = round_to<TS>(nm);
  } else {
    const float nm = __fmaf_rn(mu, mom, gd);
    w = __fmaf_rn(-lr, __fmaf_rn(mu, nm, gd), w);
    mom = round_to<TS>(nm);
  }
}

template <typename TW, typename TG, typename TS, bool MP>
__global__ void __launch_bounds__(kThreads)
    multi_sgd_kernel(const __grid_constant__ SgdArgs p) {
  const int i = find_entry(p.e, p.count, blockIdx.x);
  TW* w = static_cast<TW*>(p.e[i].w);
  const TG* g = static_cast<const TG*>(p.e[i].g);
  TS* mom = static_cast<TS*>(p.e[i].mom);
  float* w32 = p.e[i].w32;
  const long long n = p.e[i].n;
  float lr = p.lrs != nullptr ? p.lrs[i] : p.e[i].lr;
  if (p.lr != nullptr) lr = __fmul_rn(*p.lr, lr);
  const float wd = p.wds != nullptr ? p.wds[i] : p.e[i].wd;
  const int kind = p.kind;
  const bool has_mom = kind != 0;
  const float mu = p.momentum, rescale = p.rescale, clip_at = p.clip;
  const long long start =
      static_cast<long long>(blockIdx.x - p.e[i].chunk0) * kChunk;
  const long long end = start + kChunk < n ? start + kChunk : n;
  const bool vec = aligned16(w) && aligned16(g) &&
                   (!has_mom || aligned16(mom)) && (!MP || aligned16(w32));
  auto scalar = [&](long long j) {
    float wv = MP ? w32[j] : to_f<TW>(w[j]);
    float mv = has_mom ? to_f<TS>(mom[j]) : 0.f;
    const float gv = grad_in<TW>(to_f<TG>(g[j]), MP, rescale, clip_at);
    sgd_elem<TS>(wv, gv, mv, lr, wd, mu, kind);
    if (has_mom) mom[j] = from_f<TS>(mv);
    w[j] = from_f<TW>(wv);
    if (MP) w32[j] = wv;
  };
  if (!vec) {
    for (long long j = start + threadIdx.x; j < end; j += kThreads) scalar(j);
    return;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long j0 = start + (static_cast<long long>(s) * kThreads +
                                  threadIdx.x) * kVec;
    if (j0 + kVec <= end) {
      float wv[kVec], gv[kVec], mv[kVec];
      if (MP) load8<float>(w32 + j0, wv); else load8<TW>(w + j0, wv);
      load8<TG>(g + j0, gv);
      if (has_mom) {
        load8<TS>(mom + j0, mv);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) mv[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float gk = grad_in<TW>(gv[k], MP, rescale, clip_at);
        sgd_elem<TS>(wv[k], gk, mv[k], lr, wd, mu, kind);
      }
      if (has_mom) store8<TS>(mom + j0, mv);
      store8<TW>(w + j0, wv);
      if (MP) store8<float>(w32 + j0, wv);
    } else {
      for (long long j = j0; j < end; ++j) scalar(j);
    }
  }
}

// -- O3: multi_sum_sq with an all-finite flag ---------------------------------

struct SumSqEntry {
  const void* x;
  long long n;
  int chunk0;
  int dtype;
};

constexpr int kSumSqCap = 1024;  // 1024 x 24 B = 24 KB of parameters

struct SumSqArgs {
  double* partial;      // one f64 partial sum a chunk
  int* ok;              // one all-finite bit a chunk
  float* sums;          // one f32 sum of squares a tensor (this table's)
  float* flag;          // 1.0 when every element is finite, else 0.0
  int accumulate;       // AND into *flag (a later table of one list)
  int count;
  int chunks;
  SumSqEntry e[kSumSqCap];
};

// a block's sum in a fixed order: warp shuffles, then the warps in turn
__device__ __forceinline__ double block_sum(double x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kThreads / 32; ++k) total += red[k];
  }
  return total;   // valid in thread 0
}

template <typename T>
__device__ __forceinline__ void sum_sq_range(const T* x, long long start,
                                             long long end, double& acc,
                                             bool& ok) {
  auto one = [&](float f) {
    const double d = static_cast<double>(f);
    acc += d * d;
    ok = ok && isfinite(f);
  };
  if (!aligned16(x)) {
    for (long long j = start + threadIdx.x; j < end; j += kThreads)
      one(to_f<T>(x[j]));
    return;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long j0 = start + (static_cast<long long>(s) * kThreads +
                                  threadIdx.x) * kVec;
    if (j0 + kVec <= end) {
      float f[kVec];
      load8<T>(x + j0, f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) one(f[k]);
    } else {
      for (long long j = j0; j < end; ++j) one(to_f<T>(x[j]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    sum_sq_chunks_kernel(const __grid_constant__ SumSqArgs p) {
  __shared__ double red[kThreads / 32];
  const int i = find_entry(p.e, p.count, blockIdx.x);
  const long long n = p.e[i].n;
  const long long start =
      static_cast<long long>(blockIdx.x - p.e[i].chunk0) * kChunk;
  const long long end = start + kChunk < n ? start + kChunk : n;
  double acc = 0.0;
  bool ok = true;
  switch (p.e[i].dtype) {
    case 0:
      sum_sq_range(static_cast<const float*>(p.e[i].x), start, end, acc, ok);
      break;
    case 1:
      sum_sq_range(static_cast<const __nv_bfloat16*>(p.e[i].x), start, end,
                   acc, ok);
      break;
    default:
      sum_sq_range(static_cast<const __half*>(p.e[i].x), start, end, acc, ok);
      break;
  }
  const int all_ok = __syncthreads_and(ok ? 1 : 0);
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    p.partial[blockIdx.x] = total;
    p.ok[blockIdx.x] = all_ok;
  }
}

// blocks 0..count-1: one tensor's chunks summed in order; block count:
// the AND of every chunk's bit
__global__ void __launch_bounds__(kThreads)
    sum_sq_finish_kernel(const __grid_constant__ SumSqArgs p) {
  __shared__ double red[kThreads / 32];
  if (static_cast<int>(blockIdx.x) == p.count) {
    int ok = 1;
    for (int c = threadIdx.x; c < p.chunks; c += kThreads) ok &= p.ok[c];
    const int all_ok = __syncthreads_and(ok);
    if (threadIdx.x == 0) {
      const bool prev = !p.accumulate || *p.flag != 0.f;
      *p.flag = (prev && all_ok) ? 1.f : 0.f;
    }
    return;
  }
  const int i = blockIdx.x;
  const int c0 = p.e[i].chunk0;
  const int c1 = i + 1 < p.count ? p.e[i + 1].chunk0 : p.chunks;
  double acc = 0.0;
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) acc += p.partial[c];
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) p.sums[i] = static_cast<float>(total);
}

// -- host side ----------------------------------------------------------------

long long chunks_of(long long n) { return (n + kChunk - 1) / kChunk; }

// walk the tensors into tables of at most `cap` entries and call
// `launch(args, n_entries, n_chunks, first_index)` for each
template <typename Args, typename Fill, typename Launch>
int for_tables(int n, const long long* numel, int cap, bool skip_empty,
               Args* args, Fill fill, Launch launch) {
  int i = 0;
  while (i < n) {
    int count = 0, chunks = 0;
    const int first = i;
    while (i < n && count < cap) {
      if (skip_empty && numel[i] == 0) { ++i; continue; }
      fill(args->e[count], i, chunks);
      chunks += static_cast<int>(chunks_of(numel[i]));
      ++count;
      ++i;
    }
#ifdef MXTT_SKIP_LAST
    // the planted fault of the optimizer check: a table that leaves its
    // last tensor out
    if (count > 1) {
      --count;
      chunks = args->e[count].chunk0;
    }
#endif
    if (count == 0) continue;
    args->count = count;
    const int err = launch(*args, count, chunks, first);
    if (err != 0) return err;
  }
  return 0;
}

template <typename TW, typename TG, typename TS, bool MP>
int run_adamw(AdamArgs& a, int chunks, cudaStream_t s) {
  multi_adamw_kernel<TW, TG, TS, MP><<<chunks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW, typename TG, typename TS, bool MP>
int run_sgd(SgdArgs& a, int chunks, cudaStream_t s) {
  multi_sgd_kernel<TW, TG, TS, MP><<<chunks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (weight, grad, state, mp): the state is f32 (code 0) or
// the weight's dtype; mp needs an f32 state
template <class Op, typename TW, typename TG>
int by_state(int st, int mp, typename Op::Args& a, int chunks,
             cudaStream_t s) {
  if (mp) return st == 0 ? Op::template run<TW, TG, float, true>(a, chunks, s)
                         : kBadTypes;
  if (st == 0) return Op::template run<TW, TG, float, false>(a, chunks, s);
  return Op::template run<TW, TG, TW, false>(a, chunks, s);
}

template <class Op, typename TW>
int by_grad(int gt, int st, int mp, typename Op::Args& a, int chunks,
            cudaStream_t s) {
  switch (gt) {
    case 0: return by_state<Op, TW, float>(st, mp, a, chunks, s);
    case 1: return by_state<Op, TW, __nv_bfloat16>(st, mp, a, chunks, s);
    case 2: return by_state<Op, TW, __half>(st, mp, a, chunks, s);
  }
  return kBadTypes;
}

template <class Op>
int by_weight(int wt, int gt, int st, int mp, typename Op::Args& a,
              int chunks, cudaStream_t s) {
  switch (wt) {
    case 0: return by_grad<Op, float>(gt, st, mp, a, chunks, s);
    case 1: return by_grad<Op, __nv_bfloat16>(gt, st, mp, a, chunks, s);
    case 2: return by_grad<Op, __half>(gt, st, mp, a, chunks, s);
  }
  return kBadTypes;
}

struct AdamOp {
  using Args = AdamArgs;
  template <typename TW, typename TG, typename TS, bool MP>
  static int run(Args& a, int chunks, cudaStream_t s) {
    return run_adamw<TW, TG, TS, MP>(a, chunks, s);
  }
};

struct SgdOp {
  using Args = SgdArgs;
  template <typename TW, typename TG, typename TS, bool MP>
  static int run(Args& a, int chunks, cudaStream_t s) {
    return run_sgd<TW, TG, TS, MP>(a, chunks, s);
  }
};

}  // namespace

extern "C" int mxtt_optimizer_chunk() { return kChunk; }

// O1.  Per tensor i: w[i], g[i], m[i], v[i], w32[i] (null unless mp),
// numel[i], lrs[i], wds[i], etas[i].  lr and t are device scalars (the
// class forms: lrs are factors of *lr, beta^t bias correction) or null
// (the op forms: lrs are the rates, no bias correction); rescale_p is a
// device scalar or null (then `rescale`).  clip < 0 means no clipping.
// one_m_b1 and one_m_b2 are 1 - beta formed by the caller (in double,
// then rounded), as the JAX package's Python floats are.
extern "C" int mxtt_multi_adamw(int n, void* const* w, const void* const* g,
                                void* const* m, void* const* v,
                                float* const* w32, const long long* numel,
                                const float* lrs, const float* wds,
                                const float* etas, const float* lr,
                                const int* t, const float* rescale_p,
                                float rescale, float clip, float beta1,
                                float beta2, float one_m_b1,
                                float one_m_b2, float eps, int fold_wd,
                                int wtype, int gtype, int stype, int mp,
                                void* stream, int* launched) {
  // 28 KB: kept off the host stack, one a thread; filled per call
  static thread_local AdamArgs a;
  *launched = 0;
  a.lr = lr;
  a.t = t;
  a.rescale_p = rescale_p;
  a.rescale = rescale;
  a.clip = clip;
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.one_m_b1 = one_m_b1;
  a.one_m_b2 = one_m_b2;
  a.eps = eps;
  a.fold_wd = fold_wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return for_tables(
      n, numel, kAdamCap, true, &a,
      [&](AdamEntry& e, int i, int chunk0) {
        e.w = w[i];
        e.g = g[i];
        e.m = m[i];
        e.v = v[i];
        e.w32 = mp ? w32[i] : nullptr;
        e.n = numel[i];
        e.lr = lrs[i];
        e.wd = wds[i];
        e.eta = etas[i];
        e.chunk0 = chunk0;
      },
      [&](AdamArgs& args, int, int chunks, int) {
        const int err =
            by_weight<AdamOp>(wtype, gtype, stype, mp, args, chunks, s);
        if (err == 0) ++*launched;
        return err;
      });
}

// O2.  Per tensor i: w[i], g[i], mom[i] (null without momentum), w32[i]
// (null unless mp), numel[i], lrs[i], wds[i].  lr is a device scalar
// (lrs are its factors) or null; dev_lrs/dev_wds are per-tensor device
// arrays (the preloaded_ ops, which then ignore lrs/wds) or null.
// kind: 0 plain, 1 momentum, 2 Nesterov momentum.
extern "C" int mxtt_multi_sgd(int n, void* const* w, const void* const* g,
                              void* const* mom, float* const* w32,
                              const long long* numel, const float* lrs,
                              const float* wds, const float* lr,
                              const float* dev_lrs, const float* dev_wds,
                              float rescale, float clip, float momentum,
                              int kind, int wtype, int gtype, int stype,
                              int mp, void* stream, int* launched) {
  static thread_local SgdArgs a;
  *launched = 0;
  a.lr = lr;
  a.rescale = rescale;
  a.clip = clip;
  a.momentum = momentum;
  a.kind = kind;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // an empty tensor keeps its slot here: the preloaded arrays are
  // indexed by table position
  return for_tables(
      n, numel, kSgdCap, false, &a,
      [&](SgdEntry& e, int i, int chunk0) {
        e.w = w[i];
        e.g = g[i];
        e.mom = kind != 0 ? mom[i] : nullptr;
        e.w32 = mp ? w32[i] : nullptr;
        e.n = numel[i];
        e.lr = lrs[i];
        e.wd = wds[i];
        e.chunk0 = chunk0;
        e.pad = 0;
      },
      [&](SgdArgs& args, int, int chunks, int first) {
        args.lrs = dev_lrs != nullptr ? dev_lrs + first : nullptr;
        args.wds = dev_wds != nullptr ? dev_wds + first : nullptr;
        if (chunks == 0) return 0;
        const int err =
            by_weight<SgdOp>(wtype, gtype, stype, mp, args, chunks, s);
        if (err == 0) ++*launched;
        return err;
      });
}

// O3.  Per tensor i: x[i], numel[i], dtypes[i]; sums[i] gets its f32 sum
// of squares and flag[0] 1.0 if every element of every tensor is finite,
// else 0.0.  workspace holds chunks * (8 + 4) bytes
// (mxtt_optimizer_chunk() elements a chunk; an empty tensor has none).
extern "C" int mxtt_multi_sum_sq(int n, const void* const* x,
                                 const long long* numel, const int* dtypes,
                                 float* sums, float* flag, void* workspace,
                                 long long total_chunks, void* stream,
                                 int* launched) {
  static thread_local SumSqArgs a;
  *launched = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* partial = static_cast<double*>(workspace);
  int* ok = reinterpret_cast<int*>(partial + total_chunks);
  return for_tables(
      n, numel, kSumSqCap, false, &a,
      [&](SumSqEntry& e, int i, int chunk0) {
        e.x = x[i];
        e.n = numel[i];
        e.chunk0 = chunk0;
        e.dtype = dtypes[i];
      },
      [&](SumSqArgs& args, int count, int chunks, int first) {
        args.partial = partial;
        args.ok = ok;
        args.sums = sums + first;
        args.flag = flag;
        args.accumulate = first > 0;
        args.chunks = chunks;
        if (chunks > 0) {
          sum_sq_chunks_kernel<<<chunks, kThreads, 0, s>>>(args);
          ++*launched;
        }
        sum_sq_finish_kernel<<<count + 1, kThreads, 0, s>>>(args);
        ++*launched;
        partial += chunks;
        ok += chunks;
        return static_cast<int>(cudaGetLastError());
      });
}

extern "C" const char* mxtt_optimizer_error_string(int err) {
  if (err == kBadTypes) return "no kernel for this dtype combination";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
