// Flash attention forward (K1) and its two-pass backward (K2: dq, K3:
// dk and dv), for Hopper (sm_90a).
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels.py:
//   K1 _flash_fwd_kernel      (launched by _flash_pallas),
//   K2 _flash_bwd_dq_kernel   (launched by _flash_bwd_pallas),
//   K3 _flash_bwd_dkv_kernel  (launched by _flash_bwd_pallas).
// Semantics are the same.  q, k, v, dO are (BH, T, D) row-major, f32 or
// bf16, all of one type; arithmetic is f32.  The causal mask is aligned
// top-left, col <= row with both indices from 0, also when Tq != Tkv.
// K1 writes the output in the input type and a plain (BH, Tq) f32
// logsumexp (the TPU's 128-lane broadcast of lse was a tiling rule); a
// fully masked row gets output 0 and lse -inf.  K2 and K3 recompute the
// normalized probabilities p = exp(s - lse) blockwise, guarded to 0
// where lse is -inf, with ds = p * (dp - delta) and delta = rowsum(dO*O)
// computed by the caller.  No (T, T) buffer exists in either direction:
// the residuals are q, k, v, out and lse.  Ragged T is masked inside the
// kernels (the TPU version fell back to plain attention instead).
//
// Design.  The TPU ran its grid in order and held whole K/V rows in
// VMEM.  Here blocks run in parallel, in no order, and a block loops
// over tiles itself; the backward stays two-pass, as on the TPU: dq sums
// over key tiles in K2, dk and dv over query tiles in K3.  No atomics and
// no split of a sum across blocks, so the gradients are deterministic and
// two runs are bitwise equal.  Causal tiles are started heaviest first.
//
// Bound.  At the Llama-3-8B train shape (B*H = 64, T = 2048, D = 128,
// causal, bf16) each kernel is bound by operations: about 69 GFLOP (K1,
// two products), 103 GFLOP (K2, three) and 137 GFLOP (K3, four) on the
// unmasked half, against 989 TFLOP/s of bf16 tensor cores, 70-140 us,
// while its bytes take 40-60 us at 3.35 TB/s.  So the tensor cores must
// be kept busy, and all three bf16 kernels are built alike for that:
//
// Hopper kernels.  bf16 at head dims 64 and 128 with 16-byte aligned
// buffers (the Llama path) runs
//   K1 flash_fwd_wgmma_kernel      (replaces pallas_kernels.py:83),
//   K2 flash_bwd_dq_wgmma_kernel   (replaces pallas_kernels.py:166),
//   K3 flash_bwd_dkv_wgmma_kernel  (replaces pallas_kernels.py:208).
// - wgmma, the only way to the tensor cores' full rate: two consumer
//   warpgroups of 64 rows each (wgmma's M), 256 threads, f32
//   accumulators in registers.  Operands the product reads transposed (V
//   in K1, K in K2, dO and Q in K3) are read MN-major through the
//   descriptor's transpose bit, so no transposed copy exists; P and dS go
//   from their f32 accumulators to bf16 A fragments in registers.
// - TMA into a ring of shared-memory stages: thread 0 brings the tiles
//   in (3-D tensor maps (D, T, BH), so a tile past T reads zeros within
//   its own head; 128-byte swizzle, 64-column panels), the first stages
//   at the start and each later tile into the stage both warpgroups have
//   released.  A "full" mbarrier per stage counts the bytes in, an
//   "empty" one the 8 consumer warps out, so the next tiles' loads fly
//   while this tile's products run, and the copy costs the consumers no
//   instructions.  lse and delta come in as 1-D boxes from the 16-byte
//   boundary at or before the block's first row (TMA needs it).
// - No producer warps: with 8 warps a block each of the SM's four
//   register partitions holds 2 warps, so a thread may keep 255
//   registers; a ninth warp caps every thread at 168, and a producer
//   warpgroup with setmaxnreg left ptxas spilling (PERF.md).
// - Masks cost only where they bite: a tile is masked element by
//   element only where it crosses the diagonal or Tk; tiles past the
//   diagonal are never loaded, and a warpgroup skips the products of a
//   tile all of whose pairs are masked.  While the two warpgroups take
//   turns, one's exponentials run beside the other's products.
//   K1: one block per (bh, 128 query rows); Q loaded once, K and V tiles
//       of 128 keys stream through the ring.  S = Q K^T, online softmax in
//       exp2 with scale * log2(e) folded in, O += P V.
//   K2: one block per (bh, 128 query rows); Q, dO and the rows' lse and
//       delta loaded once, K and V tiles of 128 keys stream through 2
//       stages.  S = Q K^T and dP = dO V^T (both operands K-major),
//       p = exp2(s scale log2(e) - lse log2(e)), ds = p (dp - delta), then
//       dQ += dS K with K MN-major: one product more than K1 and no
//       online rescale.  The S, dP and dQ accumulators take 64 + 64 + 64
//       registers a thread at D = 128 (232 in all, no spills); 128-key
//       steps beat 64-key ones with 2 or 3 stages (PERF.md).
//   K3: one block per (bh, 128 keys); K and V resident; Q and dO tiles of
//       64 queries with their lse and delta slices stream through 3
//       stages.  S^T = K Q^T and dP^T = V dO^T put the accumulators in
//       keys x queries layout, so P^T and dS^T feed dV += P^T dO and
//       dK += dS^T Q straight from registers.  Causal blocks start at the
//       first query tile that sees their keys.
// K2 and K3 both recompute S and dP (the two-pass backward's price for
// deterministic, atomic-free gradients).  p and ds are rounded to bf16
// before their products, as FlashAttention does.  A wait on an mbarrier
// that lasts seconds (a broken phase or byte count) traps, so the launch
// fails instead of hanging.
//
// Everything else (f32, other head dims up to 256, misaligned buffers,
// including lse and delta for K2 and K3) runs f32 FMA on the CUDA cores,
// 8 warps of 8 rows, lane = key (K1, K2) or query (K3) of a 32-wide step,
// tiles staged as f32.
//
// Plain C interface, bound from Python with ctypes.  Every launch goes
// on the caller's stream; each entry point returns cudaGetLastError().

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTile = kWarps * kRowsPerWarp;   // 64 rows a block owns
constexpr int kStep = 32;                // rows per loop step = warp width
constexpr int kMaxD = 256;
constexpr int kMaxSmem = 227 * 1024;

enum DType { kF32 = 0, kBF16 = 1 };

// f32 row stride in shared memory: D rounded up to 4, plus 4, so rows
// stay 16-byte aligned and 8 consecutive rows start in distinct bank
// groups (conflict-free 16-byte reads with lane = row)
__host__ __device__ inline int smem_stride(int D) {
  return (D + 3) / 4 * 4 + 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of elements -> f32 (bit operations only)
__device__ __forceinline__ void unpack(uint4 u, float* dst, const float*) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* dst,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// rows [r0, r0 + nrows) of a (len, D) matrix -> f32 rows of stride SD in
// shared memory; rows at or past len stage zeros.  Columns D..SD stay as
// the kernel's initial zero fill left them.  vec: rows are whole
// 16-byte vectors and the matrix is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int r0,
                                          int nrows, int len, int D, int SD,
                                          bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int per_row = D / kPer;
    const int total = nrows * per_row;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kPer;
      float f[kPer];
      if (r0 + r < len) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            src + (size_t)(r0 + r) * D + c));
        unpack(u, f, src);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e) f[e] = 0.f;
      }
      float4* d4 = reinterpret_cast<float4*>(dst + r * SD + c);
#pragma unroll
      for (int e = 0; e < kPer / 4; ++e)
        d4[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                            f[4 * e + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      dst[r * SD + c] =
          r0 + r < len ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
    }
  }
}

// s[i] = a[i] . b for the warp's 8 rows a[i] (stride SD, the same for
// every lane: broadcast reads) against the lane's own row b; n4 float4s
__device__ __forceinline__ void dot8(const float* a, int SD, const float* b,
                                     int n4, float s[kRowsPerWarp]) {
  float4 acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int c = 0; c < n4; ++c) {
    const float4 y = b4[c];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float4 x = reinterpret_cast<const float4*>(a + i * SD)[c];
      acc[i].x = fmaf(x.x, y.x, acc[i].x);
      acc[i].y = fmaf(x.y, y.y, acc[i].y);
      acc[i].z = fmaf(x.z, y.z, acc[i].z);
      acc[i].w = fmaf(x.w, y.w, acc[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    s[i] = (acc[i].x + acc[i].y) + (acc[i].z + acc[i].w);
}

// acc[i][j] += sum_k w[i][k] * m[k][lane + 32 j] over the step's 32 rows
// k of m: w is the warp's 8 x 32 weight rows in shared memory (broadcast
// float4 reads), m a staged tile; columns at or past D are skipped
template <int ND>
__device__ __forceinline__ void accumulate(const float* w, const float* m,
                                           int SD, int D, int lane,
                                           float acc[kRowsPerWarp][ND]) {
#pragma unroll 2
  for (int k = 0; k < kStep; k += 4) {
    float4 wv[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      wv[i] = *reinterpret_cast<const float4*>(w + i * kStep + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        const float mv = d < D ? m[(k + u) * SD + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float wi = u == 0 ? wv[i].x : u == 1 ? wv[i].y
                         : u == 2 ? wv[i].z : wv[i].w;
          acc[i][j] = fmaf(wi, mv, acc[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_smem(float* s, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) s[i] = 0.f;
}

// ---------------------------------------------------------------------------
// K1: forward.  grid (ceil(Tq / 64), BH); shared memory fwd_smem(D)
// ---------------------------------------------------------------------------

size_t fwd_smem(int D) {
  const size_t sd = smem_stride(D);
  return sizeof(float) * ((kTile + 2 * kStep) * sd + kTile * kStep);
}

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int D, float scale,
                 int causal, int vec) {
  // causal tiles near the end of the sequence do the most work: start them
  // first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = tile * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp * kRowsPerWarp;    // the warp's first row in the tile
  const int SD = smem_stride(D), n4 = (D + 3) / 4;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kTile][SD]
  float* ks = qs + kTile * SD;                   // [kStep][SD]
  float* vs = ks + kStep * SD;                   // [kStep][SD]
  float* ps = vs + kStep * SD;                   // [kTile][kStep]
  zero_smem(qs, (kTile + 2 * kStep) * SD);
  __syncthreads();
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  load_tile(qs, qb, q0, kTile, Tq, D, SD, vec != 0);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][ND];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }
  // rows below q0 + kTile see no key past the tile's last row
  const int kend = causal ? min(Tk, q0 + kTile) : Tk;
  float* pw = ps + rb * kStep;
  for (int c0 = 0; c0 < kend; c0 += kStep) {
    __syncthreads();   // the previous step's K/V fully consumed
    load_tile(ks, kb, c0, kStep, Tk, D, SD, vec != 0);
    load_tile(vs, vb, c0, kStep, Tk, D, SD, vec != 0);
    __syncthreads();
    float s[kRowsPerWarp];
    dot8(qs + rb * SD, SD, ks + lane * SD, n4, s);
    const int c = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = q0 + rb + i;
      const bool ok = c < Tk && (!causal || c <= row);
      const float si = ok ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(si));
      // a fully masked prefix keeps m_new = -inf: exponentiate against 0
      // so masked keys give exact zeros rather than nans
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(si - safe);
      const float alpha = expf(m[i] - safe);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      pw[i * kStep + lane] = p;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();
    accumulate<ND>(pw, vs, SD, D, lane, acc);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + rb + i;
    if (row >= Tq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(o + d, acc[i][j] / safe_l);
    }
    if (lane == 0)
      lse[(size_t)bh * Tq + row] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// K2: dq.  grid (ceil(Tq / 64), BH); shared memory dq_smem(D)
// ---------------------------------------------------------------------------

size_t dq_smem(int D) {
  const size_t sd = smem_stride(D);
  return sizeof(float) * ((2 * kTile + 2 * kStep) * sd + kTile * kStep +
                          2 * kTile);
}

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tq, int Tk, int D, float scale, int causal, int vec) {
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = tile * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp * kRowsPerWarp;
  const int SD = smem_stride(D), n4 = (D + 3) / 4;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kTile][SD]
  float* dos = qs + kTile * SD;                  // [kTile][SD]
  float* ks = dos + kTile * SD;                  // [kStep][SD]
  float* vs = ks + kStep * SD;                   // [kStep][SD]
  float* dss = vs + kStep * SD;                  // [kTile][kStep]
  float* lse_s = dss + kTile * kStep;            // [kTile]
  float* delta_s = lse_s + kTile;                // [kTile]
  zero_smem(qs, (2 * kTile + 2 * kStep) * SD);
  __syncthreads();
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;
  load_tile(qs, q + qoff, q0, kTile, Tq, D, SD, vec != 0);
  load_tile(dos, dout + qoff, q0, kTile, Tq, D, SD, vec != 0);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] =
        row < Tq ? lse[(size_t)bh * Tq + row] : -INFINITY;
    delta_s[threadIdx.x] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }

  float acc[kRowsPerWarp][ND];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  const int kend = causal ? min(Tk, q0 + kTile) : Tk;
  float* dw = dss + rb * kStep;
  for (int c0 = 0; c0 < kend; c0 += kStep) {
    __syncthreads();
    load_tile(ks, k + koff, c0, kStep, Tk, D, SD, vec != 0);
    load_tile(vs, v + koff, c0, kStep, Tk, D, SD, vec != 0);
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    dot8(qs + rb * SD, SD, ks + lane * SD, n4, s);
    dot8(dos + rb * SD, SD, vs + lane * SD, n4, dp);
    const int c = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = q0 + rb + i;
      const float L = lse_s[rb + i];
      const bool ok = c < Tk && (!causal || c <= row) && isfinite(L);
      // p is the normalized probability (lse folds in the row sum)
      const float p = ok ? expf(s[i] * scale - L) : 0.f;
      dw[i * kStep + lane] = p * (dp[i] - delta_s[rb + i]);
    }
    __syncwarp();
    accumulate<ND>(dw, ks, SD, D, lane, acc);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + rb + i;
    if (row >= Tq) continue;
    T* o = dq + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(o + d, acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv.  grid (ceil(Tk / 64), BH); shared memory dkv_smem(D)
// ---------------------------------------------------------------------------

size_t dkv_smem(int D) {
  const size_t sd = smem_stride(D);
  return sizeof(float) * ((2 * kTile + 2 * kStep) * sd + 2 * kTile * kStep +
                          2 * kStep);
}

template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tq, int Tk, int D, float scale,
                     int causal, int vec) {
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kb = warp * kRowsPerWarp;    // the warp's first key in the tile
  const int SD = smem_stride(D), n4 = (D + 3) / 4;

  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [kTile][SD]
  float* vs = ks + kTile * SD;                   // [kTile][SD]
  float* qs = vs + kTile * SD;                   // [kStep][SD]
  float* dos = qs + kStep * SD;                  // [kStep][SD]
  float* pt = dos + kStep * SD;                  // [kTile][kStep]  p^T
  float* dst = pt + kTile * kStep;               // [kTile][kStep]  ds^T
  float* lse_s = dst + kTile * kStep;            // [kStep]
  float* delta_s = lse_s + kStep;                // [kStep]
  zero_smem(ks, (2 * kTile + 2 * kStep) * SD);
  __syncthreads();
  const size_t qoff = (size_t)bh * Tq * D, koff = (size_t)bh * Tk * D;
  load_tile(ks, k + koff, k0, kTile, Tk, D, SD, vec != 0);
  load_tile(vs, v + koff, k0, kTile, Tk, D, SD, vec != 0);

  float dk_acc[kRowsPerWarp][ND], dv_acc[kRowsPerWarp][ND];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  // causal: rows before k0 see none of this tile's keys
  const int qstart = causal ? k0 / kStep * kStep : 0;
  float* pw = pt + kb * kStep;
  float* dw = dst + kb * kStep;
  for (int q0 = qstart; q0 < Tq; q0 += kStep) {
    __syncthreads();
    load_tile(qs, q + qoff, q0, kStep, Tq, D, SD, vec != 0);
    load_tile(dos, dout + qoff, q0, kStep, Tq, D, SD, vec != 0);
    if (threadIdx.x < kStep) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] =
          row < Tq ? lse[(size_t)bh * Tq + row] : -INFINITY;
      delta_s[threadIdx.x] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
    }
    __syncthreads();
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    dot8(ks + kb * SD, SD, qs + lane * SD, n4, s);
    dot8(vs + kb * SD, SD, dos + lane * SD, n4, dp);
    const int row = q0 + lane;
    const float L = lse_s[lane], dl = delta_s[lane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int col = k0 + kb + i;
      const bool ok = row < Tq && col < Tk && (!causal || col <= row) &&
                      isfinite(L);
      const float p = ok ? expf(s[i] * scale - L) : 0.f;
      pw[i * kStep + lane] = p;
      dw[i * kStep + lane] = p * (dp[i] - dl);
    }
    __syncwarp();
    accumulate<ND>(pw, dos, SD, D, lane, dv_acc);
    accumulate<ND>(dw, qs, SD, D, lane, dk_acc);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int col = k0 + kb + i;
    if (col >= Tk) continue;
    T* dk_row = dk + ((size_t)bh * Tk + col) * D;
    T* dv_row = dv + ((size_t)bh * Tk + col) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        store(dk_row + d, dk_acc[i][j] * scale);
        store(dv_row + d, dv_acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consumer warpgroups and no producer warps: with 8 warps a block,
// each of the SM's four register partitions holds 2 warps, so a thread
// may keep up to 255 registers (a ninth warp would cap it at 168)
constexpr int kHopThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr uint32_t kRowBytes = 128;   // one swizzled panel row: 64 bf16
constexpr float kLn2 = 0.6931471805599453f;

// one TMA tile load into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// shared-memory matrix descriptor of a 128-byte-swizzled operand (tiles
// 1024-byte aligned, as TMA's 128-byte swizzle lays them out).  K-major:
// sbo = 1024 (8 rows of 128 bytes), lbo unused.  MN-major: lbo = the
// stride between 64-column panels, sbo = 1024 (8 rows along K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across its asynchronous window
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define MXTT_F8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MXTT_R16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MXTT_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define MXTT_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N, f32) = a b, plus d when acc; a and b bf16 in shared memory,
// both K-major.  Accumulator register i of a thread (lane = 4 g + t, warp
// w of the warpgroup) holds row 16 w + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 t + (i & 1): one 16-row slice per warp, 8 columns per
// group of 4 registers.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MXTT_R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MXTT_F8(0), MXTT_F8(8)
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MXTT_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXTT_F8(0), MXTT_F8(8), MXTT_F8(16), MXTT_F8(24)
      : "l"(a), "l"(b), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXTT_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MXTT_F8(0), MXTT_F8(8), MXTT_F8(16), MXTT_F8(24), MXTT_F8(32),
        MXTT_F8(40), MXTT_F8(48), MXTT_F8(56)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x N, f32) += a b: a one bf16 16-column A fragment in registers
// (register j of a thread holds row 16 w + g + 8 (j & 1), columns
// 8 (j >> 1) + 2 t and + 1), b bf16 in shared memory, MN-major (the
// transpose bit set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MXTT_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MXTT_F8(0), MXTT_F8(8), MXTT_F8(16), MXTT_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MXTT_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MXTT_F8(0), MXTT_F8(8), MXTT_F8(16), MXTT_F8(24), MXTT_F8(32),
        MXTT_F8(40), MXTT_F8(48), MXTT_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MXTT_F8
#undef MXTT_R16
#undef MXTT_R32
#undef MXTT_R64

// bf16 A fragments of an f32 accumulator, in place of the FA2 repack:
// fragment kc takes columns 16 kc .. 16 kc + 15
template <int KC, int N>
__device__ __forceinline__ void acc_to_frags(const float (&c)[N],
                                             uint32_t (&a)[KC][4]) {
  static_assert(N == 8 * KC, "one fragment per 16 columns");
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kc][j] = pack_bf16(c[8 * kc + 2 * j], c[8 * kc + 2 * j + 1]);
}

// the descriptor of a K-major operand's 16-column step kk: panel kk / 4
// (panels `panel` bytes apart), 32 bytes into the swizzled row per step
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, uint32_t panel,
                                                int kk) {
  return sw128_desc(tile + (kk / 4) * panel + (kk % 4) * 32, 16, 1024);
}

// the descriptor of an MN-major operand's 16-row step kc: 16 rows of 128
// bytes per step, panels `panel` bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, uint32_t panel,
                                                 int kc) {
  return sw128_desc(tile + kc * 16 * kRowBytes, panel, 1024);
}

// ---------------------------------------------------------------------------
// K1 for Hopper: grid (ceil(Tq / 128), BH), 256 threads, HopFwd<HD>::smem
// ---------------------------------------------------------------------------

template <int HD>
struct HopFwd {
  static constexpr int BR = 128, BC = 128, kStages = HD == 128 ? 2 : 3;
  static constexpr int kPanels = HD / 64;
  static constexpr uint32_t q_bytes = BR * HD * 2;    // Q, panels of BR rows
  static constexpr uint32_t kv_bytes = BC * HD * 2;   // one K or V tile
  // Q | kStages x (K tile | V tile) | mbarriers
  static constexpr uint32_t bar_off = q_bytes + 2 * kStages * kv_bytes;
  static constexpr int n_bars = 1 + 3 * kStages;  // q, k full, v full, empty
  static constexpr size_t smem = 1024 + bar_off + 8 * n_bars;
};

template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int Tq, int Tk, float scale_log2, int causal) {
  using C = HopFwd<HD>;
  constexpr int BR = C::BR, BC = C::BC, S = C::kStages;
  // causal tiles near the end of the sequence do the most work: start
  // them first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = tile * BR;
  // rows below q0 + BR see no key past the tile's last row: later key
  // tiles are never loaded
  const int kend = causal ? min(Tk, q0 + BR) : Tk;
  const int n_tiles = (kend + BC - 1) / BC;

  extern __shared__ uint8_t smem_hop[];
  const uint32_t base = (smem_u32(smem_hop) + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t bars = base + C::bar_off;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + C::q_bytes + 2 * s * C::kv_bytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + S + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: Q and the first S key tiles now, and
  // each later tile into the stage that both warpgroups have released
  const bool leader = threadIdx.x == 0;
  auto load_kv = [&](int j) {
    const int s = j % S;
    const uint32_t kt = k_tile(s), vt = kt + C::kv_bytes;
    mbar_expect_tx(k_full(s), C::kv_bytes);
    for (int p = 0; p < C::kPanels; ++p)
      tma_load_3d(kt + p * BC * kRowBytes, &k_map, k_full(s), 64 * p, j * BC,
                  bh);
    mbar_expect_tx(v_full(s), C::kv_bytes);
    for (int p = 0; p < C::kPanels; ++p)
      tma_load_3d(vt + p * BC * kRowBytes, &v_map, v_full(s), 64 * p, j * BC,
                  bh);
  };
  if (leader) {
    mbar_expect_tx(q_full, C::q_bytes);
    for (int p = 0; p < C::kPanels; ++p)
      tma_load_3d(qs + p * BR * kRowBytes, &q_map, q_full, 64 * p, q0, bh);
    for (int j = 0; j < min(S, n_tiles); ++j) load_kv(j);
  }

  const int cw = threadIdx.x / 128;          // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * cw;                // the warpgroup's first row
  const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
  const uint32_t qa = qs + cw * 64 * kRowBytes;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // running max (in units of log2, scale folded in) and this thread's
  // part of the row sums, for rows row0 and row1
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    if (leader && j > 0 && j - 1 + S < n_tiles) {
      mbar_wait(empty((j - 1) % S), ((j - 1) / S) & 1);
      load_kv(j - 1 + S);
    }
    const int s = j % S;
    const uint32_t parity = (j / S) & 1;
    const uint32_t kt = k_tile(s), vt = kt + C::kv_bytes;
    const int c0 = j * BC;
    float sc[BC / 2];
    mbar_wait(k_full(s), parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BC>(sc, kmajor_desc(qa, BR * kRowBytes, kk),
                   kmajor_desc(kt, BC * kRowBytes, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    reg_fence(sc);

#pragma unroll
    for (int i = 0; i < BC / 2; ++i) sc[i] *= scale_log2;
    // only tiles that cross the diagonal or the end of the keys mask
    if ((causal && c0 + BC - 1 > r0) || c0 + BC > Tk) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (col >= Tk || (causal && col > row)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BC / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no key yet keeps -inf: exponentiate against 0 so
      // masked keys give exact zeros rather than nans
      safe[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = fast_exp2(m[r] - safe[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      sc[i] = fast_exp2(sc[i] - safe[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[BC / 16][4];
    acc_to_frags(sc, pa);

    mbar_wait(v_full(s), parity);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < BC / 16; ++kc)
      wgmma_rs<HD>(o, pa[kc], mnmajor_desc(vt, BC * kRowBytes, kc));
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    reg_fence(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r ? row1 : row0;
    if (row >= Tq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    bf16* orow = out + ((size_t)bh * Tq + row) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * Tq + row] =
          l[r] == 0.f ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K3 for Hopper: grid (ceil(Tk / 128), BH), 256 threads, HopDkv<HD>::smem
// ---------------------------------------------------------------------------

template <int HD>
struct HopDkv {
  static constexpr int BK = 128, BQ = 64, kStages = 3, kPanels = HD / 64;
  static constexpr uint32_t kv_bytes = BK * HD * 2;   // K or V, resident
  static constexpr uint32_t t_bytes = BQ * HD * 2;    // a Q or dO tile
  // an lse or delta slice: TMA starts a box on a 16-byte boundary of the
  // flat (BH * Tq) vector, so a box of BQ + 4 entries starts up to 3
  // entries early; each slice sits 128-byte aligned
  static constexpr int kRowBox = BQ + 4;
  static constexpr uint32_t row_bytes = 384;
  // K | V | kStages x (Q | dO) | kStages x (lse | delta) | mbarriers
  static constexpr uint32_t ring_off = 2 * kv_bytes;
  static constexpr uint32_t rows_off = ring_off + kStages * 2 * t_bytes;
  static constexpr uint32_t bar_off = rows_off + kStages * 2 * row_bytes;
  static constexpr int n_bars = 1 + 2 * kStages;     // k/v, full, empty
  static constexpr size_t smem = 1024 + bar_off + 8 * n_bars;
  static constexpr uint32_t stage_tx = 2 * t_bytes + 2 * kRowBox * 4;
};

template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap lse_map,
                           const __grid_constant__ CUtensorMap delta_map,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Tq, int Tk, float scale, float scale_log2,
                           int causal) {
  using C = HopDkv<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, S = C::kStages;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  // causal: rows before k0 see none of this block's keys
  const int qstart = causal ? k0 : 0;
  const int n_tiles = Tq > qstart ? (Tq - qstart + BQ - 1) / BQ : 0;

  extern __shared__ uint8_t smem_hop[];
  const uint32_t base = (smem_u32(smem_hop) + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_hop + (base - smem_u32(smem_hop));
  const uint32_t ks = base, vs = base + C::kv_bytes;
  const uint32_t bars = base + C::bar_off;
  const uint32_t kv_full = bars;
  auto q_tile = [&](int s) { return base + C::ring_off + 2 * s * C::t_bytes; };
  auto rows_at = [&](int s) { return C::rows_off + 2 * s * C::row_bytes; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: K, V and the first S query tiles now,
  // and each later tile into the stage that both warpgroups have released
  const bool leader = threadIdx.x == 0;
  auto load_q = [&](int j) {
    const int s = j % S;
    const int q0 = qstart + j * BQ;
    const uint32_t qt = q_tile(s), dot = qt + C::t_bytes;
    mbar_expect_tx(full(s), C::stage_tx);
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load_3d(qt + p * BQ * kRowBytes, &q_map, full(s), 64 * p, q0, bh);
      tma_load_3d(dot + p * BQ * kRowBytes, &do_map, full(s), 64 * p, q0, bh);
    }
    // lse and delta as flat (BH * Tq) vectors, from the 16-byte boundary
    // at or before this tile's first query: entries past this head's Tq
    // belong to the next head (or read zeros past the end), and the mask
    // drops those queries
    const int r0 = (bh * Tq + q0) & ~3;
    tma_load_1d(base + rows_at(s), &lse_map, full(s), r0);
    tma_load_1d(base + rows_at(s) + C::row_bytes, &delta_map, full(s), r0);
  };
  if (leader) {
    mbar_expect_tx(kv_full, 2 * C::kv_bytes);
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load_3d(ks + p * BK * kRowBytes, &k_map, kv_full, 64 * p, k0, bh);
      tma_load_3d(vs + p * BK * kRowBytes, &v_map, kv_full, 64 * p, k0, bh);
    }
    for (int j = 0; j < min(S, n_tiles); ++j) load_q(j);
  }

  const int cw = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kmin = k0 + 64 * cw;              // the warpgroup's first key
  const int key0 = kmin + 16 * warp + g, key1 = key0 + 8;
  const uint32_t ka = ks + cw * 64 * kRowBytes, va = vs + cw * 64 * kRowBytes;

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    if (leader && j > 0 && j - 1 + S < n_tiles) {
      mbar_wait(empty((j - 1) % S), ((j - 1) / S) & 1);
      load_q(j - 1 + S);
    }
    const int s = j % S;
    const int q0 = qstart + j * BQ;
    const uint32_t qt = q_tile(s), dot = qt + C::t_bytes;
    mbar_wait(full(s), (j / S) & 1);
    // a tile whose queries all precede the warpgroup's keys adds nothing
    if (!(causal && q0 + BQ - 1 < kmin)) {
      float st[BQ / 2], dpt[BQ / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BQ>(st, kmajor_desc(ka, BK * kRowBytes, kk),
                     kmajor_desc(qt, BQ * kRowBytes, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BQ>(dpt, kmajor_desc(va, BK * kRowBytes, kk),
                     kmajor_desc(dot, BQ * kRowBytes, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      const float* lse_s =
          reinterpret_cast<const float*>(base_ptr + rows_at(s)) +
          ((bh * Tq + q0) & 3);
      const float* delta_s = lse_s + C::row_bytes / 4;
      const bool masked = (causal && kmin + 63 > q0) || q0 + BQ > Tq ||
                          kmin + 64 > Tk;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float L[2] = {lse_s[8 * n + 2 * t], lse_s[8 * n + 2 * t + 1]};
        const float dl[2] = {delta_s[8 * n + 2 * t],
                             delta_s[8 * n + 2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          const float lq = L[e & 1];
          // p is the normalized probability (lse folds in the row sum);
          // a row whose lse is -inf gets p = 0
          const float l2 = lq == -INFINITY ? INFINITY : lq * kLog2e;
          float p = fast_exp2(fmaf(st[i], scale_log2, -l2));
          if (masked) {
            const int query = q0 + 8 * n + 2 * t + (e & 1);
            const int key = e & 2 ? key1 : key0;
            if (query >= Tq || key >= Tk || (causal && key > query))
              p = 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl[e & 1]);   // ds^T
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      acc_to_frags(st, pa);
      acc_to_frags(dpt, da);
      reg_fence(dva);
      reg_fence(dka);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs<HD>(dva, pa[kc], mnmajor_desc(dot, BQ * kRowBytes, kc));
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)
        wgmma_rs<HD>(dka, da[kc], mnmajor_desc(qt, BQ * kRowBytes, kc));
      wg_commit();
      wg_wait_all();
      reg_fence(dva);
      reg_fence(dka);
      reg_fence(pa);
      reg_fence(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= Tk) continue;
    bf16* dk_row = dk + ((size_t)bh * Tk + key) * HD;
    bf16* dv_row = dv + ((size_t)bh * Tk + key) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk_row + 8 * n + 2 * t) = pack_bf16(
          dka[4 * n + 2 * r] * scale, dka[4 * n + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv_row + 8 * n + 2 * t) =
          pack_bf16(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 for Hopper: grid (ceil(Tq / 128), BH), 256 threads, HopDq<HD>::smem
// ---------------------------------------------------------------------------

template <int HD>
struct HopDq {
  static constexpr int BR = 128, BC = 128, kStages = 2, kPanels = HD / 64;
  static constexpr uint32_t t_bytes = BR * HD * 2;    // Q or dO, resident
  static constexpr uint32_t kv_bytes = BC * HD * 2;   // one K or V tile
  // the block's lse and delta slices, as in K3: a box of BR + 4 entries
  // from the 16-byte boundary at or before bh * Tq + q0, 128-byte aligned
  static constexpr int kRowBox = BR + 4;
  static constexpr uint32_t row_bytes = 640;
  static_assert(kRowBox * 4 <= row_bytes, "an lse slice overflows its slot");
  // Q | dO | kStages x (K tile | V tile) | lse | delta | mbarriers
  static constexpr uint32_t ring_off = 2 * t_bytes;
  static constexpr uint32_t rows_off = ring_off + 2 * kStages * kv_bytes;
  static constexpr uint32_t bar_off = rows_off + 2 * row_bytes;
  // Q/dO/lse/delta, k full, v full, empty
  static constexpr int n_bars = 1 + 3 * kStages;
  static constexpr size_t smem = 1024 + bar_off + 8 * n_bars;
  static constexpr uint32_t q_tx = 2 * t_bytes + 2 * kRowBox * 4;
};

template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap lse_map,
                          const __grid_constant__ CUtensorMap delta_map,
                          bf16* __restrict__ dq, int Tq, int Tk, float scale,
                          float scale_log2, int causal) {
  using C = HopDq<HD>;
  constexpr int BR = C::BR, BC = C::BC, S = C::kStages;
  // causal tiles near the end of the sequence do the most work: start
  // them first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = tile * BR;
  // rows below q0 + BR see no key past the tile's last row: later key
  // tiles are never loaded
  const int kend = causal ? min(Tk, q0 + BR) : Tk;
  const int n_tiles = (kend + BC - 1) / BC;
  // the first lse/delta entry of the block in the flat (BH * Tq) vectors
  const int rbase = bh * Tq + q0;

  extern __shared__ uint8_t smem_hop[];
  const uint32_t base = (smem_u32(smem_hop) + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_hop + (base - smem_u32(smem_hop));
  const uint32_t qs = base, dos = base + C::t_bytes;
  const uint32_t bars = base + C::bar_off;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) {
    return base + C::ring_off + 2 * s * C::kv_bytes;
  };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + S + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every load: Q, dO, lse, delta and the first S key
  // tiles now, and each later tile into the stage that both warpgroups
  // have released
  const bool leader = threadIdx.x == 0;
  auto load_kv = [&](int j) {
    const int s = j % S;
    const uint32_t kt = k_tile(s), vt = kt + C::kv_bytes;
    mbar_expect_tx(k_full(s), C::kv_bytes);
    for (int p = 0; p < C::kPanels; ++p)
      tma_load_3d(kt + p * BC * kRowBytes, &k_map, k_full(s), 64 * p, j * BC,
                  bh);
    mbar_expect_tx(v_full(s), C::kv_bytes);
    for (int p = 0; p < C::kPanels; ++p)
      tma_load_3d(vt + p * BC * kRowBytes, &v_map, v_full(s), 64 * p, j * BC,
                  bh);
  };
  if (leader) {
    mbar_expect_tx(q_full, C::q_tx);
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load_3d(qs + p * BR * kRowBytes, &q_map, q_full, 64 * p, q0, bh);
      tma_load_3d(dos + p * BR * kRowBytes, &do_map, q_full, 64 * p, q0, bh);
    }
    // entries past this head's Tq belong to the next head (or read zeros
    // past the end); those rows are never written
    tma_load_1d(base + C::rows_off, &lse_map, q_full, rbase & ~3);
    tma_load_1d(base + C::rows_off + C::row_bytes, &delta_map, q_full,
                rbase & ~3);
    for (int j = 0; j < min(S, n_tiles); ++j) load_kv(j);
  }

  const int cw = threadIdx.x / 128;          // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * cw;                // the warpgroup's first row
  const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
  const uint32_t qa = qs + cw * 64 * kRowBytes;
  const uint32_t doa = dos + cw * 64 * kRowBytes;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);
  // lse in units of log2 (+inf where lse is -inf, so p = 0 there) and
  // delta, for rows row0 and row1
  float l2[2], dl[2];
  {
    const float* lse_s =
        reinterpret_cast<const float*>(base_ptr + C::rows_off) + (rbase & 3);
    const float* delta_s = lse_s + C::row_bytes / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 64 * cw + 16 * warp + g + 8 * r;
      const float lq = lse_s[i];
      l2[r] = lq == -INFINITY ? INFINITY : lq * kLog2e;
      dl[r] = delta_s[i];
    }
  }
  for (int j = 0; j < n_tiles; ++j) {
    if (leader && j > 0 && j - 1 + S < n_tiles) {
      mbar_wait(empty((j - 1) % S), ((j - 1) / S) & 1);
      load_kv(j - 1 + S);
    }
    const int s = j % S;
    const uint32_t parity = (j / S) & 1;
    const uint32_t kt = k_tile(s), vt = kt + C::kv_bytes;
    const int c0 = j * BC;
    mbar_wait(k_full(s), parity);
    mbar_wait(v_full(s), parity);
    // a tile whose keys all follow the warpgroup's last row adds nothing
    if (!(causal && c0 > r0 + 63)) {
      // S = Q K^T and dP = dO V^T, both operands K-major in shared memory
      float sc[BC / 2], dp[BC / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BC>(sc, kmajor_desc(qa, BR * kRowBytes, kk),
                     kmajor_desc(kt, BC * kRowBytes, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BC>(dp, kmajor_desc(doa, BR * kRowBytes, kk),
                     kmajor_desc(vt, BC * kRowBytes, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      // only tiles that cross the diagonal or the end of the keys mask
      const bool masked = (causal && c0 + BC - 1 > r0) || c0 + BC > Tk;
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int r = (i >> 1) & 1;
        // p is the normalized probability (lse folds in the row sum)
        float p = fast_exp2(fmaf(sc[i], scale_log2, -l2[r]));
        if (masked) {
          const int col = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col >= Tk || (causal && col > (r ? row1 : row0))) p = 0.f;
        }
        sc[i] = p * (dp[i] - dl[r]);   // ds
      }
      // dQ += dS K: dS repacked to bf16 A fragments in registers, K read
      // as an MN-major B operand through the descriptor's transpose bit
      uint32_t da[BC / 16][4];
      acc_to_frags(sc, da);
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BC / 16; ++kc)
        wgmma_rs<HD>(acc, da[kc], mnmajor_desc(kt, BC * kRowBytes, kc));
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
      reg_fence(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // rows past Tq (which read the next head's lse) are never written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Tq) continue;
    bf16* o = dq + ((size_t)bh * Tq + row) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) = pack_bf16(
          acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
bool vec_ok(int D, const void* const* ptrs, int n) {
  if ((D * sizeof(T)) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

int head_groups(int D) {   // ND: 32-column groups a lane owns
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;
}

template <typename T, int ND>
int fwd_nd(const void* q, const void* k, const void* v, void* out,
           float* lse, int BH, int Tq, int Tk, int D, float scale,
           int causal, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, ND>;
  const size_t smem = fwd_smem(D);
  int e = prepare(kernel, smem);
  if (e) return e;
  const void* ptrs[] = {q, k, v, out};
  const int vec = vec_ok<T>(D, ptrs, 4);
  dim3 grid((Tq + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tq, Tk, D, scale,
      causal, vec);
  return (int)cudaGetLastError();
}

template <typename T, int ND>
int dq_nd(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, void* dq, int BH, int Tq,
          int Tk, int D, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, ND>;
  const size_t smem = dq_smem(D);
  int e = prepare(kernel, smem);
  if (e) return e;
  const void* ptrs[] = {q, k, v, dout};
  const int vec = vec_ok<T>(D, ptrs, 4);
  dim3 grid((Tq + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tq, Tk, D, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T, int ND>
int dkv_nd(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int BH,
           int Tq, int Tk, int D, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, ND>;
  const size_t smem = dkv_smem(D);
  int e = prepare(kernel, smem);
  if (e) return e;
  const void* ptrs[] = {q, k, v, dout};
  const int vec = vec_ok<T>(D, ptrs, 4);
  dim3 grid((Tk + kTile - 1) / kTile, BH);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, D, scale, causal,
      vec);
  return (int)cudaGetLastError();
}

// dispatch on (dtype, ND) to a launcher template F<T, ND>
#define MXTT_DISPATCH(F, dtype, D, ...)                                     \
  do {                                                                     \
    const int nd_ = head_groups(D);                                        \
    if ((dtype) == kF32) {                                                 \
      if (nd_ == 1) return F<float, 1>(__VA_ARGS__);                       \
      if (nd_ == 2) return F<float, 2>(__VA_ARGS__);                       \
      if (nd_ == 4) return F<float, 4>(__VA_ARGS__);                       \
      return F<float, 8>(__VA_ARGS__);                                     \
    }                                                                      \
    if ((dtype) == kBF16) {                                                \
      if (nd_ == 1) return F<__nv_bfloat16, 1>(__VA_ARGS__);               \
      if (nd_ == 2) return F<__nv_bfloat16, 2>(__VA_ARGS__);               \
      if (nd_ == 4) return F<__nv_bfloat16, 4>(__VA_ARGS__);               \
      return F<__nv_bfloat16, 8>(__VA_ARGS__);                             \
    }                                                                      \
    return (int)cudaErrorInvalidValue;                                     \
  } while (0)

bool bad_shape(int BH, int Tq, int Tk, int D) {
  return BH <= 0 || BH > 65535 || Tq <= 0 || Tk < 0 || D <= 0 || D > kMaxD;
}

// the Hopper kernels (K1, K2 and K3 on wgmma) take bf16 at head dims 64
// and 128, 16-byte aligned; everything else runs on the f32 CUDA-core
// kernels
bool use_tc(int dtype, int D, const void* const* ptrs, int n) {
  if (dtype != kBF16 || (D != 64 && D != 128)) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

// a (BH, T, D) bf16 tensor as the 3-D map (D, T, BH): boxes of 64 columns
// x `rows` rows of one head, 128-byte swizzle; rows past T read zeros
int tile_map(CUtensorMap* map, const void* ptr, int BH, int T, int D,
             int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a flat f32 vector of n entries, boxes of `len`; entries past n read zeros
int row_map(CUtensorMap* map, const void* ptr, long long n, int len) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};   // rank 1: none is read
  const cuuint32_t box[1] = {(cuuint32_t)len};
  const cuuint32_t step[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int fwd_hopper(const void* q, const void* k, const void* v, void* out,
               float* lse, int BH, int Tq, int Tk, float scale, int causal,
               cudaStream_t st) {
  using C = HopFwd<HD>;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  int e = prepare(kernel, C::smem);
  if (e) return e;
  CUtensorMap qm, km, vm;
  memset(&km, 0, sizeof km);
  memset(&vm, 0, sizeof vm);
  if ((e = tile_map(&qm, q, BH, Tq, HD, C::BR))) return e;
  // no key: no tile is loaded, and every row gets out 0 and lse -inf
  if (Tk > 0 && ((e = tile_map(&km, k, BH, Tk, HD, C::BC)) ||
                 (e = tile_map(&vm, v, BH, Tk, HD, C::BC))))
    return e;
  dim3 grid((Tq + C::BR - 1) / C::BR, BH);
  kernel<<<grid, kHopThreads, C::smem, st>>>(qm, km, vm, static_cast<bf16*>(out),
                                             lse, Tq, Tk, scale * kLog2e,
                                             causal);
  return (int)cudaGetLastError();
}

template <int HD>
int dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int BH, int Tq, int Tk, float scale, int causal,
               cudaStream_t st) {
  using C = HopDkv<HD>;
  auto kernel = flash_bwd_dkv_wgmma_kernel<HD>;
  int e = prepare(kernel, C::smem);
  if (e) return e;
  CUtensorMap qm, km, vm, dom, lm, dm;
  if ((e = tile_map(&qm, q, BH, Tq, HD, C::BQ)) ||
      (e = tile_map(&km, k, BH, Tk, HD, C::BK)) ||
      (e = tile_map(&vm, v, BH, Tk, HD, C::BK)) ||
      (e = tile_map(&dom, dout, BH, Tq, HD, C::BQ)) ||
      (e = row_map(&lm, lse, (long long)BH * Tq, C::kRowBox)) ||
      (e = row_map(&dm, delta, (long long)BH * Tq, C::kRowBox)))
    return e;
  dim3 grid((Tk + C::BK - 1) / C::BK, BH);
  kernel<<<grid, kHopThreads, C::smem, st>>>(
      qm, km, vm, dom, lm, dm, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Tq, Tk, scale, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int HD>
int dq_hopper(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int BH, int Tq,
              int Tk, float scale, int causal, cudaStream_t st) {
  using C = HopDq<HD>;
  auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
  int e = prepare(kernel, C::smem);
  if (e) return e;
  CUtensorMap qm, km, vm, dom, lm, dm;
  memset(&km, 0, sizeof km);
  memset(&vm, 0, sizeof vm);
  if ((e = tile_map(&qm, q, BH, Tq, HD, C::BR)) ||
      (e = tile_map(&dom, dout, BH, Tq, HD, C::BR)) ||
      (e = row_map(&lm, lse, (long long)BH * Tq, C::kRowBox)) ||
      (e = row_map(&dm, delta, (long long)BH * Tq, C::kRowBox)))
    return e;
  // no key: no tile is loaded, and dq is 0
  if (Tk > 0 && ((e = tile_map(&km, k, BH, Tk, HD, C::BC)) ||
                 (e = tile_map(&vm, v, BH, Tk, HD, C::BC))))
    return e;
  dim3 grid((Tq + C::BR - 1) / C::BR, BH);
  kernel<<<grid, kHopThreads, C::smem, st>>>(
      qm, km, vm, dom, lm, dm, static_cast<bf16*>(dq), Tq, Tk, scale,
      scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mxtt_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int Tq, int Tk,
                              int D, float scale, int causal, int dtype,
                              void* stream) {
  if (bad_shape(BH, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  const void* ptrs[] = {q, k, v, out};
  if (use_tc(dtype, D, ptrs, 4))
    return D == 64 ? fwd_hopper<64>(q, k, v, out, lse_f, BH, Tq, Tk, scale,
                                    causal, st)
                   : fwd_hopper<128>(q, k, v, out, lse_f, BH, Tq, Tk, scale,
                                     causal, st);
  MXTT_DISPATCH(fwd_nd, dtype, D, q, k, v, out, lse_f, BH, Tq, Tk, D, scale,
                causal, st);
}

extern "C" int mxtt_flash_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dq, int BH, int Tq, int Tk, int D,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (bad_shape(BH, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<const float*>(delta);
  // the Hopper kernel also reads lse and delta through TMA: 16-byte
  // aligned as well
  const void* ptrs[] = {q, k, v, dout, dq, lse, delta};
  if (use_tc(dtype, D, ptrs, 7))
    return D == 64 ? dq_hopper<64>(q, k, v, dout, lse_f, delta_f, dq, BH,
                                   Tq, Tk, scale, causal, st)
                   : dq_hopper<128>(q, k, v, dout, lse_f, delta_f, dq, BH,
                                    Tq, Tk, scale, causal, st);
  MXTT_DISPATCH(dq_nd, dtype, D, q, k, v, dout, lse_f, delta_f, dq, BH, Tq,
                Tk, D, scale, causal, st);
}

extern "C" int mxtt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int BH, int Tq, int Tk,
                                  int D, float scale, int causal, int dtype,
                                  void* stream) {
  if (bad_shape(BH, Tq, Tk, D) || Tk == 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<const float*>(lse);
  auto* delta_f = static_cast<const float*>(delta);
  // the Hopper kernel also reads lse and delta through TMA: 16-byte
  // aligned as well
  const void* ptrs[] = {q, k, v, dout, dk, dv, lse, delta};
  if (use_tc(dtype, D, ptrs, 8))
    return D == 64 ? dkv_hopper<64>(q, k, v, dout, lse_f, delta_f, dk, dv,
                                    BH, Tq, Tk, scale, causal, st)
                   : dkv_hopper<128>(q, k, v, dout, lse_f, delta_f, dk, dv,
                                     BH, Tq, Tk, scale, causal, st);
  MXTT_DISPATCH(dkv_nd, dtype, D, q, k, v, dout, lse_f, delta_f, dk, dv, BH,
                Tq, Tk, D, scale, causal, st);
}

extern "C" const char* mxtt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
