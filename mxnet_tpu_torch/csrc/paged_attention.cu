// Paged attention over the serving arena's block tables (decode, verify
// and chunk steps), for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/paged_attention.py::_paged_kernel
// (launched by _paged_pallas).  Semantics are the same: query token j of
// lane b sits at position positions[b] + j and attends the lane's context
// positions <= positions[b] + j, on pages named by block_table[b, :];
// page 0 is the arena's null page and is always masked; int8 pages are
// dequantized by one f32 scale per page; a fully masked query row
// returns 0.  GQA is folded into the query rows exactly as on the TPU:
// row r = j*G + g of kv-head kvh is query head kvh*G + g of token j, so
// the grouped heads share every K/V load.
//
// Design.  The TPU kernel carried the online-softmax state (m, l, acc)
// in VMEM across a sequential page grid axis.  Hopper blocks run in no
// order, so here one block owns one (lane, kv-head, tile of RT query
// rows, split) and walks its share of the lane's context itself, 32 keys
// per step, with the softmax state in shared memory and registers.  The
// block reads its lane's block-table row into shared memory once (there
// is no scalar prefetch).  Keys past the last position any row of the
// tile can see are never loaded.
//
// Bound.  Decode is memory bound: the kernel must read every live K/V
// row once, 2 * ctx * KV * D * bytes/elt per lane per layer (4 KiB per
// token of context for Llama-3-8B in bf16; 8 lanes at 1,024 tokens read
// 32 MiB, about 10 us at 3.35 TB/s).  Tensor cores do not help: decode
// has 4 grouped query rows per kv-head.  So the work is to keep enough
// bytes in flight on every SM, and the design does three things:
// - Split the context (flash-decoding).  At decode only B * KV * row
//   tiles blocks exist (64 for 8-lane Llama-3-8B, on 132 SMs), each a
//   chain of latencies.  The host splits each lane's context over n_split
//   blocks, picked from the launch shape alone (about 3 blocks per SM,
//   at most 16): split s takes the 32-key steps s, s + n_split, ...,
//   interleaved, because the host does not know the lanes' positions
//   without a sync.  Each split writes its unnormalized acc, m and l in
//   f32 to scratch the wrapper allocates, and paged_combine_kernel adds
//   the splits in the fixed order 0 .. n_split - 1 (deterministic for a
//   launch shape).  It is launched as a programmatic dependent launch,
//   so its launch overlaps the attention grid.  With n_split = 1 (chunked
//   prefill, large batches) the block writes the normalized output and
//   nothing else runs.
// - A ring of shared-memory stages (2; stages - 1 steps in flight while
//   one is computed), filled 16 bytes a thread by cp.async where K/V rows
//   are whole, aligned 16-byte vectors, else element by element.  Masked
//   keys stage zeros without a read.  Each step's page ids and row
//   indices are computed once, by one warp, a step ahead of its copies.
//   K/V stay in their storage type in the stage (bf16, f32 or int8 with
//   per-page scales folded into the scores and p) and are converted to
//   f32 as they are read.  (TMA page boxes were tried: at the 8-lane
//   decode shape they tied the cp.async ring, PERF.md.)
// - Short dependency chains: each warp takes a quarter of the head
//   dimension of every key against every row of the tile (RT independent
//   sums, K read from the stage once), the partial sums meet in shared
//   memory, the exponentials are exp2 on the SFU with log2(e) folded into
//   the queries, each lane keeps its own share of the row sums, and the
//   product with V takes 8 keys at a time.  The row count RT is a
//   template parameter (4, 8 or 16), so decode's four grouped rows do no
//   work for empty rows.
// What still bounds it at decode is latency, not bandwidth: every block
// starts with two dependent round trips (its table row, then its first
// pages) and then does only a few steps, so at the 8-lane decode shape
// it reaches about a third of the byte bound, against three quarters
// once 64 lanes fill the card (PERF.md).
//
// Plain C interface, bound from Python with ctypes.  The launch goes on
// the caller's stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;              // keys per step = warp width
constexpr int kMaxD = 256;
constexpr int kDimsPerThread = kMaxD / kThreads;   // acc columns/thread
constexpr int kMaxStages = 2;          // K/V ring stages (2 to 4)
constexpr int kSlots = kMaxStages + 1;  // page-id slots: one step more
constexpr int kMaxSplit = 16;          // blocks a lane's context splits over
constexpr size_t kMaxSmem = 227 * 1024;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// f32 row stride in shared memory: whole 16-byte groups plus one, so
// rows stay 16-byte aligned and 8 consecutive rows start in 8 distinct
// bank groups (conflict-free 16-byte accesses with lane = row)
__host__ __device__ inline int smem_stride(int D) {
  return (D + 3) / 4 * 4 + 4;
}

// K/V row stride of a ring stage in bytes: the row rounded up to 16
// bytes, plus 16, so 8 consecutive rows start in 8 distinct bank groups
// (conflict-free 16-byte reads with lane = key)
__host__ __device__ inline int stage_stride(int D, int esize) {
  return (D * esize + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of K or V elements -> f32 into dst[0 .. 16/sizeof(KT)) (bit
// operations only, so the vector stays in registers)
__device__ __forceinline__ void unpack(uint4 v, float* dst, const float*) {
  dst[0] = __uint_as_float(v.x);
  dst[1] = __uint_as_float(v.y);
  dst[2] = __uint_as_float(v.z);
  dst[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float* dst,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 v, float* dst, const int8_t*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[4 * i + e] =
          static_cast<float>(static_cast<int>(w[i] << (24 - 8 * e)) >> 24);
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only); with
// fill false nothing is read and the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void put_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void put_zero(__nv_bfloat16* p) {
  *reinterpret_cast<unsigned short*>(p) = 0;
}
__device__ __forceinline__ void put_zero(int8_t* p) { *p = 0; }

// grid (B, KV, ceil(k1*G / RT) * n_split), block kThreads, dynamic
// shared memory sized by smem_bytes(), `stages` (2 to 4) ring stages.
// vec: K/V rows are whole 16-byte vectors, 16-byte aligned, copied by
// cp.async; else the scalar load path.  With n_split = 1 the block writes
// the normalized output; else split `split` writes its unnormalized acc,
// m and l in f32 to part_acc (n_split, B*k1*H, D) and part_ml (n_split,
// B*k1*H, 2), and paged_combine_kernel reduces them.
template <typename QT, typename KT, int RT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const KT* __restrict__ k_pages,
                       const KT* __restrict__ v_pages,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ positions,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       QT* __restrict__ out, float* __restrict__ part_acc,
                       float* __restrict__ part_ml,
                       int k1, int H, int KV, int D, int S, int maxp,
                       float scale, bool vec, int n_split, int stages) {
  constexpr int kRowsPerWarp = RT / kWarps;
  constexpr int kPer = 16 / sizeof(KT);      // elements per 16 bytes
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int QG = k1 * G;
  const int split = blockIdx.z % n_split;
  const int r0 = blockIdx.z / n_split * RT;
  const int nrows = min(RT, QG - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int SD = smem_stride(D);
  const int RS = stage_stride(D, sizeof(KT));
  const size_t row_bytes = (size_t)D * sizeof(KT);
  const int kv_bytes = kKeys * RS;           // the K (or V) rows of a stage

  // stages x (K rows | V rows) | queries | partial scores | p | m, l,
  // alpha | page ids and rows | the lane's table
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(ring + stages * 2 * kv_bytes);
  float* part = qs + RT * SD;                // [kWarps][RT][kKeys]
  float* ps = part + kWarps * RT * kKeys;    // [RT][kKeys] p * v scale
  float* m_s = ps + RT * kKeys;              // [RT] running max
  float* l_s = m_s + RT;                     // [RT] running sum
  float* a_s = l_s + RT;                     // [RT] rescale this step
  // per step (a ring of kSlots): each key's page id (0: masked) and its
  // K/V row in the pages, computed one step ahead of its copies
  int* kpid = reinterpret_cast<int*>(a_s + RT);   // [kSlots][kKeys]
  int* krow = kpid + kSlots * kKeys;         // [kSlots][kKeys]
  int* tbl = krow + kSlots * kKeys;          // [maxp] this lane's table

  // let the combine kernel's blocks launch now; they wait for this grid
  // to finish before reading anything
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int pos_b = positions[b];
  // the lane's block-table row, read once: page lookups in the key loop
  // then cost a shared-memory read instead of a dependent global load
#pragma unroll 4
  for (int i = tid; i < maxp; i += kThreads)
    tbl[i] = block_table[(size_t)b * maxp + i];
  // queries of this tile, scaled once (as the TPU kernel does) and by
  // log2(e), so scores, m and the exponentials are in units of log2;
  // rows past nrows are zeros.  Unrolled so the loads issue together.
  const float scale_log2 = scale * kLog2e;
#pragma unroll 4
  for (int i = tid; i < RT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int rg = r0 + r, j = rg / G, h = kvh * G + rg % G;
    qs[r * SD + d] =
        r < nrows
            ? to_f32(q[(((size_t)b * k1 + j) * H + h) * D + d]) * scale_log2
            : 0.f;
  }
  if (tid < RT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[RT][kDimsPerThread];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerThread; ++c) acc[r][c] = 0.f;
  // this lane's share of the row sums of the warp's rows; the warp adds
  // them up once, after the last step
  float l_lane[kRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) l_lane[u] = 0.f;

  // keys any row of this tile can see: positions <= pos_b + j_last
  const int j_last = (r0 + nrows - 1) / G;
  const int n_keys = min(maxp * S, pos_b + j_last + 1);
  // split `split` takes the 32-key steps split, split + n_split, ...:
  // interleaved, so every split has work whatever the lane's position
  const int first = split * kKeys, stride = n_split * kKeys;
  const int n_steps =
      first < n_keys ? (n_keys - first + stride - 1) / stride : 0;
  const int VR = D / kPer;                   // 16-byte parts of a row

  // step i's page ids and rows (keys c0 .. c0 + 31), by the first warp.
  // A masked key (null page, or past the context) gets page id 0.  The
  // slot of step i is free once step i - 1 is done: kSlots = kMaxStages +
  // 1 slots, and step i is computed while step i - stages is
  auto rows_of = [&](int i) {
    if (tid < kKeys) {
      const int c = first + i * stride + tid;
      const int pg = c / S;
      const int pid = c < n_keys ? tbl[pg] : 0;
      kpid[(i % kSlots) * kKeys + tid] = pid;
      krow[(i % kSlots) * kKeys + tid] = (pid * S + c - pg * S) * KV + kvh;
    }
  };
  // the K and V rows of step i into stage i % stages.  A masked key reads
  // nothing and stages zeros: the null page holds whatever inactive lanes
  // wrote there, and keys past the context are never loaded
  auto load = [&](int i) {
    const int st = i % stages;
    const int* pids = kpid + (i % kSlots) * kKeys;
    const int* rows = krow + (i % kSlots) * kKeys;
    uint8_t* ks = ring + st * 2 * kv_bytes;
    uint8_t* vs = ks + kv_bytes;
    if (vec) {
      // neighbouring threads copy neighbouring 16 bytes of a row; where
      // the row's parts divide the block, a thread keeps one part and
      // steps over keys
      const int key_step = kThreads % VR == 0 ? kThreads / VR : 0;
      const int n_ch = key_step ? kKeys : kKeys * VR;
#pragma unroll 4
      for (int ch = key_step ? tid / VR : tid; ch < n_ch;
           ch += key_step ? key_step : kThreads) {
        const int key = key_step ? ch : ch / VR;
        const int part = key_step ? tid % VR : ch - key * VR;
        const int pid = pids[key];
        const size_t off = (size_t)rows[key] * row_bytes + part * 16;
        cp_async16(smem_u32(ks + key * RS + part * 16),
                   reinterpret_cast<const uint8_t*>(k_pages) + off, pid != 0);
        cp_async16(smem_u32(vs + key * RS + part * 16),
                   reinterpret_cast<const uint8_t*>(v_pages) + off, pid != 0);
      }
    } else {
      for (int e = tid; e < kKeys * D; e += kThreads) {
        const int key = e / D, d = e - key * D;
        KT* kd = reinterpret_cast<KT*>(ks + key * RS) + d;
        KT* vd = reinterpret_cast<KT*>(vs + key * RS) + d;
        if (pids[key] != 0) {
          const size_t off = (size_t)rows[key] * D + d;
          *kd = k_pages[off];
          *vd = v_pages[off];
        } else {
          put_zero(kd);
          put_zero(vd);
        }
      }
    }
  };

  __syncthreads();   // table row (and queries) visible to every thread
  for (int i = 0; i < stages && i < n_steps; ++i) rows_of(i);
  __syncthreads();
  // the ring: stages - 1 steps in flight ahead of the one computed
  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_steps) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    // step i has landed (this thread's copies; the barrier makes every
    // thread's visible), and every thread is done with step i - 1, whose
    // stage the next load refills
    switch (stages) {
      case 4: cp_async_wait<2>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<0>();
    }
    __syncthreads();
    if (i + stages - 1 < n_steps) load(i + stages - 1);
    cp_async_commit();
    // the rows of the step the next iteration loads, into the slot of
    // step i - 1, which every thread is done with
    if (i + stages < n_steps) rows_of(i + stages);
    const int st = i % stages;
    const int c0 = first + i * stride;
    const uint8_t* ks = ring + st * 2 * kv_bytes;
    const uint8_t* vs = ks + kv_bytes;

    // scores: lane = key; warp w takes the 16-byte parts w, w + 4, ... of
    // the key's K row (converted once) against every row of the tile, so
    // K is read from the stage once and each row's sum is its own chain;
    // the four warps' partial sums meet in shared memory
    float sc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) sc[r] = 0.f;
    if (vec) {
#pragma unroll 2
      for (int pt = warp; pt < VR; pt += kWarps) {
        float kf[kPer];
        unpack(*reinterpret_cast<const uint4*>(ks + lane * RS + pt * 16), kf,
               k_pages);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4* qr =
              reinterpret_cast<const float4*>(qs + r * SD + pt * kPer);
          float s = sc[r];
#pragma unroll
          for (int e = 0; e < kPer / 4; ++e) {
            const float4 qv = qr[e];
            s = fmaf(qv.x, kf[4 * e], s);
            s = fmaf(qv.y, kf[4 * e + 1], s);
            s = fmaf(qv.z, kf[4 * e + 2], s);
            s = fmaf(qv.w, kf[4 * e + 3], s);
          }
          sc[r] = s;
        }
      }
    } else {
      const uint8_t* krow = ks + lane * RS;
      for (int d = warp; d < D; d += kWarps) {
        const float kf = to_f32(reinterpret_cast<const KT*>(krow)[d]);
#pragma unroll
        for (int r = 0; r < RT; ++r)
          sc[r] = fmaf(qs[r * SD + d], kf, sc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) part[(warp * RT + r) * kKeys + lane] = sc[r];
    __syncthreads();

    // online softmax; p is stored times the key's value scale, so the
    // product below reads raw values
    const int pid = kpid[(i % kSlots) * kKeys + lane];
    const int c = c0 + lane;
    const float ksc = k_scale != nullptr && pid != 0 ? k_scale[pid] : 1.f;
    const float vsc = v_scale != nullptr && pid != 0 ? v_scale[pid] : 1.f;
    // warp w owns rows w, w + 4, ...; the partial sums add in a fixed
    // order
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = warp + u * kWarps;
      if (r >= nrows) {   // warp-uniform
        ps[r * kKeys + lane] = 0.f;
        if (lane == 0) a_s[r] = 1.f;
        continue;
      }
      const float dot = (part[r * kKeys + lane] +
                         part[(RT + r) * kKeys + lane]) +
                        (part[(2 * RT + r) * kKeys + lane] +
                         part[(3 * RT + r) * kKeys + lane]);
      const int j = (r0 + r) / G;
      const bool ok = c < n_keys && c <= pos_b + j && pid != 0;
      const float s = ok ? dot * ksc : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      // a fully masked prefix keeps m_new = -inf: exponentiate against 0
      // so masked keys give exact zeros rather than nans
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float p = fast_exp2(s - safe);
      const float alpha = fast_exp2(m_old - safe);
      l_lane[u] = l_lane[u] * alpha + p;
      ps[r * kKeys + lane] = p * vsc;
      __syncwarp();   // every lane has read m_s[r]
      if (lane == 0) {
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_k p[r][k] * v[k][d]; empty
    // rows have p = 0 and alpha = 1, so no row needs a branch
#pragma unroll
    for (int cc = 0; cc < kDimsPerThread; ++cc) {
      const int d = tid + cc * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r][cc] *= a_s[r];
        // eight keys at a time: two 16-byte reads of each row's p
#pragma unroll 2
        for (int k8 = 0; k8 < kKeys; k8 += 8) {
          const uint8_t* vk = vs + k8 * RS + d * (int)sizeof(KT);
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = to_f32(*reinterpret_cast<const KT*>(vk + u * RS));
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 p0 = *reinterpret_cast<const float4*>(
                ps + r * kKeys + k8);
            const float4 p1 = *reinterpret_cast<const float4*>(
                ps + r * kKeys + k8 + 4);
            float a = acc[r][cc];
            a = fmaf(p0.x, v[0], a);
            a = fmaf(p0.y, v[1], a);
            a = fmaf(p0.z, v[2], a);
            a = fmaf(p0.w, v[3], a);
            a = fmaf(p1.x, v[4], a);
            a = fmaf(p1.y, v[5], a);
            a = fmaf(p1.z, v[6], a);
            acc[r][cc] = fmaf(p1.w, v[7], a);
          }
        }
      }
    }
  }
  // the row sums: each warp adds up its lanes' shares
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const float l = warp_sum(l_lane[u]);
    if (lane == 0) l_s[warp + u * kWarps] = l;
  }
  __syncthreads();

  if (n_split > 1) {
    // this split's part: acc unnormalized, with its m and l; a split that
    // saw no key of a row writes acc 0, m -inf, l 0
    const size_t rows = (size_t)gridDim.x * k1 * H;
#pragma unroll
    for (int cc = 0; cc < kDimsPerThread; ++cc) {
      const int d = tid + cc * kThreads;
      if (d < D) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < nrows) {
            const int rg = r0 + r, j = rg / G, h = kvh * G + rg % G;
            const size_t o = split * rows + ((size_t)b * k1 + j) * H + h;
            part_acc[o * D + d] = acc[r][cc];
          }
        }
      }
    }
    if (tid < nrows) {
      const int rg = r0 + tid, j = rg / G, h = kvh * G + rg % G;
      const size_t o = split * rows + ((size_t)b * k1 + j) * H + h;
      part_ml[2 * o] = m_s[tid];
      part_ml[2 * o + 1] = l_s[tid];
    }
    return;
  }

#pragma unroll
  for (int cc = 0; cc < kDimsPerThread; ++cc) {
    const int d = tid + cc * kThreads;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < nrows) {
          const int rg = r0 + r, j = rg / G, h = kvh * G + rg % G;
          const float l = l_s[r];
          store(out + (((size_t)b * k1 + j) * H + h) * D + d,
                acc[r][cc] / (l == 0.f ? 1.f : l));
        }
      }
    }
  }
}

// grid ceil(rows / kWarps), block kThreads: warp w of block x combines
// output row x * kWarps + w of the (rows, D) output from the n_split
// parts, in the fixed order 0 .. n_split - 1, so the result does not
// depend on which split finished first.  MXTT_DROP_SPLIT=<s> leaves part
// s out: a planted fault that the checks must catch.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, QT* __restrict__ out,
                     int rows, int D, int n_split) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // launched early (programmatic dependent launch): wait here until the
  // attention grid has finished and its parts are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (row >= rows) return;
  // every split's m, l and accumulator columns at once, so the loads
  // are in flight together (one round trip)
  constexpr int kCols = kMaxD / 32;
  float ms[kMaxSplit], ls[kMaxSplit], as[kMaxSplit][kCols];
#pragma unroll
  for (int s = 0; s < kMaxSplit; ++s) {
    const bool use = s < n_split
#ifdef MXTT_DROP_SPLIT
                     && s != MXTT_DROP_SPLIT
#endif
        ;
    const size_t o = (size_t)s * rows + row;
    ms[s] = use ? part_ml[2 * o] : -INFINITY;
    ls[s] = use ? part_ml[2 * o + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane + 32 * i;
      as[s][i] = use && d < D ? part_acc[o * D + d] : 0.f;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < kMaxSplit; ++s) m = fmaxf(m, ms[s]);
  // a row no split saw keeps m = -inf and returns 0; an empty (or
  // dropped) split has m -inf and weight 0
  const float safe = m == -INFINITY ? 0.f : m;
  float num[kCols], den = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) num[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplit; ++s) {
    const float w = exp2f(ms[s] - safe);   // m in units of log2
    den = fmaf(w, ls[s], den);
#pragma unroll
    for (int i = 0; i < kCols; ++i) num[i] = fmaf(w, as[s][i], num[i]);
  }
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D)
      store(out + (size_t)row * D + d, den == 0.f ? 0.f : num[i] / den);
  }
}

size_t smem_bytes(int D, int esize, int maxp, int rt, int stages) {
  return (size_t)stages * 2 * kKeys * stage_stride(D, esize) +
         sizeof(float) * ((size_t)rt * smem_stride(D) +
                          (kWarps + 1) * rt * kKeys + 3 * rt) +
         sizeof(int) * ((size_t)2 * kSlots * kKeys + maxp);
}

template <typename QT, typename KT, int RT>
int launch_rt(const void* q, const void* k_pages, const void* v_pages,
              const int32_t* block_table, const int32_t* positions,
              const float* k_scale, const float* v_scale, void* out,
              float* part_acc, float* part_ml, int B, int k1, int H, int KV,
              int D, int S, int maxp, float scale, int n_split,
              cudaStream_t stream) {
  const int row_tiles = (k1 * (H / KV) + RT - 1) / RT;
  if ((long long)row_tiles * n_split > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, KV, row_tiles * n_split);
  // 16-byte copies need whole, aligned vectors per K/V row
  const bool vec = D * sizeof(KT) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  // kMaxStages ring stages where they fit, else fewer (at least two)
  int stages = kMaxStages;
  while (stages > 2 &&
         smem_bytes(D, sizeof(KT), maxp, RT, stages) > kMaxSmem)
    --stages;
  const size_t smem = smem_bytes(D, sizeof(KT), maxp, RT, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<QT, KT, RT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), block_table, positions, k_scale,
      v_scale, static_cast<QT*>(out), part_acc, part_ml, k1, H, KV, D, S,
      maxp, scale, vec, n_split, stages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  // the combine, as a programmatic dependent launch: its launch overlaps
  // the attention grid's tail instead of following it
  const int rows = B * k1 * H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pacc = part_acc;
  const float* pml = part_ml;
  e = cudaLaunchKernelEx(&cfg, paged_combine_kernel<QT>, pacc, pml,
                         static_cast<QT*>(out), rows, D, n_split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int32_t* block_table, const int32_t* positions,
           const float* k_scale, const float* v_scale, void* out,
           float* part_acc, float* part_ml, int B, int k1, int H, int KV,
           int D, int S, int maxp, float scale, int n_split,
           cudaStream_t stream) {
  // the smallest row tile that holds the k1 * G query rows of a kv-head
  // (the wrapper mirrors this choice when it picks n_split)
  const int qg = k1 * (H / KV);
#define MXTT_LAUNCH_RT(rt)                                                  \
  launch_rt<QT, KT, rt>(q, k_pages, v_pages, block_table, positions,      \
                        k_scale, v_scale, out, part_acc, part_ml, B, k1, H, \
                        KV, D, S, maxp, scale, n_split, stream)
  if (qg <= 4) return MXTT_LAUNCH_RT(4);
  if (qg <= 8) return MXTT_LAUNCH_RT(8);
  return MXTT_LAUNCH_RT(16);
#undef MXTT_LAUNCH_RT
}

template <typename QT>
int launch_q(int kv_dtype, const void* q, const void* k_pages,
             const void* v_pages, const int32_t* block_table,
             const int32_t* positions, const float* k_scale,
             const float* v_scale, void* out, float* part_acc,
             float* part_ml, int B, int k1, int H, int KV, int D, int S,
             int maxp, float scale, int n_split, cudaStream_t stream) {
#define MXTT_LAUNCH(KT)                                                     \
  launch<QT, KT>(q, k_pages, v_pages, block_table, positions, k_scale,      \
                 v_scale, out, part_acc, part_ml, B, k1, H, KV, D, S, maxp, \
                 scale, n_split, stream)
  switch (kv_dtype) {
    case kF32:
      return MXTT_LAUNCH(float);
    case kBF16:
      return MXTT_LAUNCH(__nv_bfloat16);
    case kI8:
      return MXTT_LAUNCH(int8_t);
  }
#undef MXTT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_pages and v_pages are (P, S, KV, D).  n_split > 1 splits each lane's
// context over n_split blocks and needs the f32 scratch part_acc
// (n_split * B * k1 * H * D) and part_ml (n_split * B * k1 * H * 2),
// allocated by the caller
extern "C" int mxtt_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* positions, const void* k_scale,
    const void* v_scale, void* out, void* part_acc, void* part_ml, int B,
    int k1, int H, int KV, int D, int S, int maxp, float scale,
    int q_dtype, int kv_dtype, int n_split, void* stream) {
  if (B <= 0 || k1 <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D > kMaxD ||
      S <= 0 || maxp <= 0 || n_split <= 0 || n_split > kMaxSplit ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* tbl = static_cast<const int32_t*>(block_table);
  const auto* pos = static_cast<const int32_t*>(positions);
  const auto* ksc = static_cast<const float*>(k_scale);
  const auto* vsc = static_cast<const float*>(v_scale);
  auto* pacc = static_cast<float*>(part_acc);
  auto* pml = static_cast<float*>(part_ml);
  auto st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_q<float>(kv_dtype, q, k_pages, v_pages, tbl, pos, ksc,
                             vsc, out, pacc, pml, B, k1, H, KV, D, S, maxp,
                             scale, n_split, st);
    case kBF16:
      return launch_q<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, tbl, pos,
                                     ksc, vsc, out, pacc, pml, B, k1, H, KV,
                                     D, S, maxp, scale, n_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
