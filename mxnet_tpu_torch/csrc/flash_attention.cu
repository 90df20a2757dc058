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
// over tiles itself:
//   K1, K2: one block per (bh, tile of 64 query rows), looping over keys
//           (only up to the diagonal when causal);
//   K3:     one block per (bh, tile of 64 keys), looping over queries
//           (only from the diagonal down when causal).
// The backward stays two-pass, as on the TPU: dq sums over key tiles in
// K2, dk and dv over query tiles in K3.  No atomics, so the gradients
// are deterministic and two runs are bitwise equal.  Causal tiles are
// started heaviest first.  Each kernel comes in two versions:
//   - bf16 at head dims 64 and 128 (the Llama path): bf16 tensor cores
//     through mma.sync m16n8k16 with f32 accumulation, 4 warps of 16
//     rows each; the probabilities and ds go from the accumulator
//     fragments straight into the next product's operand fragments, in
//     registers, rounded to bf16 as FlashAttention-2 does (below);
//   - f32, and bf16 at other head dims up to 256: f32 FMA on the CUDA
//     cores, 8 warps of 8 rows, lane = key (K1, K2) or query (K3) of a
//     32-wide step, tiles staged as f32 (below, first).
//
// Bound.  At the Llama-3-8B train shape (B*H = 64, T = 2048, D = 128,
// causal, bf16) each kernel is bound by operations: about 69 GFLOP (K1),
// 103 GFLOP (K2) and 137 GFLOP (K3) of products on the unmasked half,
// against 989 TFLOP/s of bf16 tensor cores, 70-140 us, while its bytes
// take 40-60 us at 3.35 TB/s.  The tensor-core version moves the
// products onto the tensor cores but still stages every tile with plain
// loads between two barriers, so loads and products do not overlap, and
// mma.sync reaches only part of the wgmma rate; TMA, a pipelined ring of
// tiles and wgmma are the later work that closes the gap.
//
// Plain C interface, bound from Python with ctypes.  Every launch goes
// on the caller's stream; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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
// bf16 tensor-core versions (head dims 64 and 128): mma.sync m16n8k16
// with f32 accumulation.  4 warps; each warp owns 16 rows of the block's
// 64-row tile.  Tiles are staged in shared memory as bf16 with a padded
// row stride (8 elements), row-major where the tile is an mma A operand
// or the n-major B operand, and transposed where it is the k-major B
// operand (V in K1, K in K2, Q and dO in K3).  The probabilities and ds
// go from the f32 accumulator fragments straight into A fragments in
// registers, rounded to bf16, as FlashAttention-2 does.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16x16 chunk at (r0, c0) of row-major X (stride sx);
// g = lane / 4, t = lane % 4
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* X, int sx,
                                       int r0, int c0, int g, int t) {
  const bf16* p = X + (r0 + g) * sx + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * sx);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * sx + 8);
}

// B fragment of the 16(k) x 8(n) chunk at (k0, n0), from Y stored [n][k]
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* Y, int sy,
                                       int n0, int k0, int g, int t) {
  const bf16* p = Y + (n0 + g) * sy + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// the A fragment of columns 16 kc.. of a 16 x N product from its two
// accumulator fragments (n-tiles 2 kc and 2 kc + 1), rounded to bf16
__device__ __forceinline__ void frag_a_from_c(uint32_t a[4], const float c0[4],
                                              const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows [r0, r0 + n) of a (len, HD) bf16 matrix -> shared rows of stride
// SX, 16 bytes at a time; rows at or past len stage zeros
template <int HD, int SX>
__device__ __forceinline__ void tc_rows(bf16* dst, const bf16* __restrict__ src,
                                        int r0, int n, int len) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < n * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len)
      u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c));
    *reinterpret_cast<uint4*>(dst + r * SX + c) = u;
  }
}

// the same rows transposed: dst[d][r] (stride ST); neighbouring threads
// take neighbouring rows, so the 2-byte stores hit distinct banks
template <int HD, int ST>
__device__ __forceinline__ void tc_cols(bf16* dst, const bf16* __restrict__ src,
                                        int r0, int n, int len) {
  for (int i = threadIdx.x; i < n * (HD / 8); i += kTcThreads) {
    const int r = i % n, c = (i / n) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < len)
      u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[(c + j) * ST + r] = __ushort_as_bfloat16(static_cast<unsigned short>(
          j & 1 ? w[j >> 1] >> 16 : w[j >> 1] & 0xffffu));
  }
}

template <int HD>
struct TcFwd {
  static constexpr int BR = 64, BC = 64, SX = HD + 8, ST = BC + 8;
  static constexpr size_t smem =
      sizeof(bf16) * ((size_t)(BR + BC) * SX + (size_t)HD * ST);
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int Tq, int Tk, float scale,
                    int causal) {
  using C = TcFwd<HD>;
  constexpr int BR = C::BR, BC = C::BC, SX = C::SX, ST = C::ST;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = tile * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  const int row0 = q0 + rw + g, row1 = row0 + 8;

  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);   // [BR][SX]
  bf16* ks = qs + BR * SX;                        // [BC][SX]
  bf16* vt = ks + BC * SX;                        // [HD][ST]
  const bf16* kb = k + (size_t)bh * Tk * HD;
  const bf16* vb = v + (size_t)bh * Tk * HD;
  tc_rows<HD, SX>(qs, q + (size_t)bh * Tq * HD, q0, BR, Tq);

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int kend = causal ? min(Tk, q0 + BR) : Tk;
  for (int c0 = 0; c0 < kend; c0 += BC) {
    __syncthreads();
    tc_rows<HD, SX>(ks, kb, c0, BC, Tk);
    tc_cols<HD, ST>(vt, vb, c0, BC, Tk);
    __syncthreads();
    float s[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4];
      frag_a(a, qs, SX, rw, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b[2];
        frag_b(b, ks, SX, n * 8, kc * 16, g, t);
        mma_bf16(s[n], a, b);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = col < Tk && (!causal || col <= row);
        s[n][e] = ok ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      safe[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m[r] - safe[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - safe[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < BC / 16; ++kc) {
      uint32_t a[4];
      frag_a_from_c(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        uint32_t b[2];
        frag_b(b, vt, ST, d * 8, kc * 16, g, t);
        mma_bf16(o[d], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Tq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = out + ((size_t)bh * Tq + row) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8 + 2 * t) =
          pack_bf16(o[d][2 * r] / safe_l, o[d][2 * r + 1] / safe_l);
    if (t == 0)
      lse[(size_t)bh * Tq + row] =
          l[r] == 0.f ? -INFINITY : m[r] + logf(safe_l);
  }
}

template <int HD>
struct TcDq {
  static constexpr int BR = 64, BC = 64, SX = HD + 8, ST = BC + 8;
  static constexpr size_t smem =
      sizeof(bf16) * ((size_t)(2 * BR + 2 * BC) * SX + (size_t)HD * ST) +
      sizeof(float) * 2 * BR;
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Tq, int Tk, float scale, int causal) {
  using C = TcDq<HD>;
  constexpr int BR = C::BR, BC = C::BC, SX = C::SX, ST = C::ST;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = tile * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  const int row0 = q0 + rw + g, row1 = row0 + 8;

  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);   // [BR][SX]
  bf16* dos = qs + BR * SX;                       // [BR][SX]
  bf16* ks = dos + BR * SX;                       // [BC][SX]
  bf16* vs = ks + BC * SX;                        // [BC][SX]
  bf16* kt = vs + BC * SX;                        // [HD][ST]
  float* lse_s = reinterpret_cast<float*>(kt + HD * ST);   // [BR]
  float* delta_s = lse_s + BR;                              // [BR]
  const size_t qoff = (size_t)bh * Tq * HD, koff = (size_t)bh * Tk * HD;
  tc_rows<HD, SX>(qs, q + qoff, q0, BR, Tq);
  tc_rows<HD, SX>(dos, dout + qoff, q0, BR, Tq);
  if (threadIdx.x < BR) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < Tq ? lse[(size_t)bh * Tq + row] : -INFINITY;
    delta_s[threadIdx.x] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const int kend = causal ? min(Tk, q0 + BR) : Tk;
  for (int c0 = 0; c0 < kend; c0 += BC) {
    __syncthreads();
    tc_rows<HD, SX>(ks, k + koff, c0, BC, Tk);
    tc_rows<HD, SX>(vs, v + koff, c0, BC, Tk);
    tc_cols<HD, ST>(kt, k + koff, c0, BC, Tk);
    __syncthreads();
    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4], a2[4];
      frag_a(a, qs, SX, rw, kc * 16, g, t);
      frag_a(a2, dos, SX, rw, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t b[2];
        frag_b(b, ks, SX, n * 8, kc * 16, g, t);
        mma_bf16(s[n], a, b);
        frag_b(b, vs, SX, n * 8, kc * 16, g, t);
        mma_bf16(dp[n], a2, b);
      }
    }
    const float L[2] = {lse_s[rw + g], lse_s[rw + g + 8]};
    const float dl[2] = {delta_s[rw + g], delta_s[rw + g + 8]};
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const int row = r ? row1 : row0;
        const bool ok =
            col < Tk && (!causal || col <= row) && isfinite(L[r]);
        const float p = ok ? expf(s[n][e] * scale - L[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[r]);      // ds
      }
#pragma unroll
    for (int kc = 0; kc < BC / 16; ++kc) {
      uint32_t a[4];
      frag_a_from_c(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        uint32_t b[2];
        frag_b(b, kt, ST, d * 8, kc * 16, g, t);
        mma_bf16(acc[d], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Tq) continue;
    bf16* o = dq + ((size_t)bh * Tq + row) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(o + d * 8 + 2 * t) =
          pack_bf16(acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
  }
}

template <int HD>
struct TcDkv {
  static constexpr int BK = 64, BQ = 32, SX = HD + 8, SQ = BQ + 8;
  static constexpr size_t smem =
      sizeof(bf16) * ((size_t)(2 * BK + 2 * BQ) * SX + 2 * (size_t)HD * SQ) +
      sizeof(float) * 2 * BQ;
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq,
                        int Tk, float scale, int causal) {
  using C = TcDkv<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, SX = C::SX, SQ = C::SQ;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;                 // the warp's first key
  const int key0 = k0 + rw + g, key1 = key0 + 8;

  extern __shared__ uint4 smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);   // [BK][SX]
  bf16* vs = ks + BK * SX;                        // [BK][SX]
  bf16* qs = vs + BK * SX;                        // [BQ][SX]
  bf16* dos = qs + BQ * SX;                       // [BQ][SX]
  bf16* qt = dos + BQ * SX;                       // [HD][SQ]
  bf16* dot = qt + HD * SQ;                       // [HD][SQ]
  float* lse_s = reinterpret_cast<float*>(dot + HD * SQ);  // [BQ]
  float* delta_s = lse_s + BQ;                              // [BQ]
  const size_t qoff = (size_t)bh * Tq * HD, koff = (size_t)bh * Tk * HD;
  tc_rows<HD, SX>(ks, k + koff, k0, BK, Tk);
  tc_rows<HD, SX>(vs, v + koff, k0, BK, Tk);

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  // causal: rows before k0 see none of this tile's keys
  const int qstart = causal ? k0 : 0;
  for (int q0 = qstart; q0 < Tq; q0 += BQ) {
    __syncthreads();
    tc_rows<HD, SX>(qs, q + qoff, q0, BQ, Tq);
    tc_rows<HD, SX>(dos, dout + qoff, q0, BQ, Tq);
    tc_cols<HD, SQ>(qt, q + qoff, q0, BQ, Tq);
    tc_cols<HD, SQ>(dot, dout + qoff, q0, BQ, Tq);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < Tq ? lse[(size_t)bh * Tq + row] : -INFINITY;
      delta_s[threadIdx.x] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
    }
    __syncthreads();
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4], a2[4];
      frag_a(a, ks, SX, rw, kc * 16, g, t);
      frag_a(a2, vs, SX, rw, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        uint32_t b[2];
        frag_b(b, qs, SX, n * 8, kc * 16, g, t);
        mma_bf16(s[n], a, b);                // s^T = k q^T
        frag_b(b, dos, SX, n * 8, kc * 16, g, t);
        mma_bf16(dp[n], a2, b);              // dp^T = v dO^T
      }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        const int row = q0 + qi;
        const int key = e < 2 ? key0 : key1;
        const float L = lse_s[qi];
        const bool ok = row < Tq && key < Tk && (!causal || key <= row) &&
                        isfinite(L);
        const float p = ok ? expf(s[n][e] * scale - L) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[qi]);   // ds^T
      }
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t a[4], a2[4];
      frag_a_from_c(a, s[2 * kc], s[2 * kc + 1]);
      frag_a_from_c(a2, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        uint32_t b[2];
        frag_b(b, dot, SQ, d * 8, kc * 16, g, t);
        mma_bf16(dva[d], a, b);              // dv += p^T dO
        frag_b(b, qt, SQ, d * 8, kc * 16, g, t);
        mma_bf16(dka[d], a2, b);             // dk += ds^T q
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= Tk) continue;
    bf16* ok_row = dk + ((size_t)bh * Tk + key) * HD;
    bf16* ov_row = dv + ((size_t)bh * Tk + key) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<uint32_t*>(ok_row + d * 8 + 2 * t) =
          pack_bf16(dka[d][2 * r] * scale, dka[d][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(ov_row + d * 8 + 2 * t) =
          pack_bf16(dva[d][2 * r], dva[d][2 * r + 1]);
    }
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

// the tensor-core kernels take bf16 at head dims 64 and 128, 16-byte
// aligned; everything else runs on the f32 CUDA-core kernels
bool use_tc(int dtype, int D, const void* const* ptrs, int n) {
  if (dtype != kBF16 || (D != 64 && D != 128)) return false;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return false;
  return true;
}

template <int HD>
int fwd_tc(const void* q, const void* k, const void* v, void* out,
           float* lse, int BH, int Tq, int Tk, float scale, int causal,
           cudaStream_t st) {
  auto kernel = flash_fwd_tc_kernel<HD>;
  int e = prepare(kernel, TcFwd<HD>::smem);
  if (e) return e;
  dim3 grid((Tq + TcFwd<HD>::BR - 1) / TcFwd<HD>::BR, BH);
  kernel<<<grid, kTcThreads, TcFwd<HD>::smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Tq, Tk,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int HD>
int dq_tc(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, void* dq, int BH, int Tq,
          int Tk, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_bwd_dq_tc_kernel<HD>;
  int e = prepare(kernel, TcDq<HD>::smem);
  if (e) return e;
  dim3 grid((Tq + TcDq<HD>::BR - 1) / TcDq<HD>::BR, BH);
  kernel<<<grid, kTcThreads, TcDq<HD>::smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int HD>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int BH,
           int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_tc_kernel<HD>;
  int e = prepare(kernel, TcDkv<HD>::smem);
  if (e) return e;
  dim3 grid((Tk + TcDkv<HD>::BK - 1) / TcDkv<HD>::BK, BH);
  kernel<<<grid, kTcThreads, TcDkv<HD>::smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, scale,
      causal);
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
    return D == 64 ? fwd_tc<64>(q, k, v, out, lse_f, BH, Tq, Tk, scale,
                                causal, st)
                   : fwd_tc<128>(q, k, v, out, lse_f, BH, Tq, Tk, scale,
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
  const void* ptrs[] = {q, k, v, dout, dq};
  if (use_tc(dtype, D, ptrs, 5))
    return D == 64 ? dq_tc<64>(q, k, v, dout, lse_f, delta_f, dq, BH, Tq,
                               Tk, scale, causal, st)
                   : dq_tc<128>(q, k, v, dout, lse_f, delta_f, dq, BH, Tq,
                                Tk, scale, causal, st);
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
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  if (use_tc(dtype, D, ptrs, 6))
    return D == 64 ? dkv_tc<64>(q, k, v, dout, lse_f, delta_f, dk, dv, BH,
                                Tq, Tk, scale, causal, st)
                   : dkv_tc<128>(q, k, v, dout, lse_f, delta_f, dk, dv, BH,
                                 Tq, Tk, scale, causal, st);
  MXTT_DISPATCH(dkv_nd, dtype, D, q, k, v, dout, lse_f, delta_f, dk, dv, BH,
                Tq, Tk, D, scale, causal, st);
}

extern "C" const char* mxtt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
