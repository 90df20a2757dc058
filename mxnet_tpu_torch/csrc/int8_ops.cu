// int8 x int8 -> int32 products for Hopper (sm_90a): O5 int8_gemm and
// O6 int8_conv, one source and one tensor-core loop.
//
// No Pallas kernel stands behind these.  The JAX package hands its int8
// contractions to XLA with preferred_element_type=int32 (the MXU's int8
// mode): ops/quantized_ops.py's _quantized_fc (dot_general) and
// _quantized_conv (conv_general_dilated), and contrib/quantization.py's
// QuantizedDense and QuantizedConv2D, the layers quantize_net_v2 swaps
// into a Gluon net.  Torch has no int8 convolution on CUDA, and the port
// takes no library GEMM on its path, so both are written here.
//
// What is computed.  O6 is a 2-D convolution as an implicit GEMM:
//   x   (N, H, W, C)        s8, channels last, contiguous
//   w   (O, KH, KW, C / G)  s8 (OHWI), contiguous
//   out (N, P, Q, O)        s32 or f32, contiguous
// with stride, zero padding (an int8 0), dilation and G groups (depthwise
// included).  For group g the GEMM has M = N * P * Q rows (output
// pixels), O / G columns (that group's filters) and K = KH * KW * C / G,
// ordered (kh, kw, c) as the weight's rows are, so both operands are
// K-contiguous.  O5 is O6 at H = W = KH = KW = 1: C[M, N] = sum_k
// A[M, k] * B[N, k], the contraction dot_general takes over (ndim-1, 1).
//
// Epilogues, per output element, from the exact s32 sum acc:
//   kEpiS32: acc + bias[o] (s32, wrapping; bias may be null), the
//            registered ops' raw accumulator plus their rounded s32 bias;
//   kEpiF32: __fdiv_rn(__int2float_rn(acc), denom) then __fadd_rn with
//            bias[o] (f32; may be null): the layers' f32(acc) / f32(x_scale
//            * w_scale) + bias, each operation rounded once, never
//            contracted.
// The sums are exact (|acc| <= 127 * 127 * K, 7.4e7 at ResNet-50's K of
// 4,608) and the epilogue is correctly rounded, so the outputs equal the
// plain version's (ops/int8_ops.py) bit for bit.
//
// Bound.  With f32 outputs, ResNet-50's convolutions are bound by bytes
// (3.35 TB/s), not by the 1,979 TOP/s of int8: at batch 256 the 53 of
// them write about 9 GB, a bound of 4.14 ms with s8 inputs, about 6.4 ms
// with the layers' f32 activations read in their place (the f32 mode),
// of which 0.27 ms is operations (chip_smoke.py's quant phase).
//
// Two routes.  The wgmma route (below: mxtt_int8_conv_wgmma) is the
// Hopper design and takes the layers' f32 mode and s8 operands whose C/G
// is a multiple of 16, aligned.  The mma_sync route (mxtt_int8_conv, the
// first design) takes depthwise convolutions and the other s8 calls:
// - a block of 256 threads takes a 128 x 128 tile of one group's output
//   and walks K in steps of 64 bytes through two stages of shared memory;
//   its 8 warps each hold a 64 x 32 tile in registers as 4 x 4
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 accumulators;
// - shared rows are 80 bytes (64 + 16 of padding), so the 32-bit fragment
//   reads of a warp's 8 rows x 4 words fall on 32 distinct banks;
// - the vector path (C / G a multiple of 16 and both operands 16-byte
//   aligned) copies 16-byte chunks with cp.async; the byte path (odd group
//   widths, depthwise, K tails not a multiple of 16, misaligned views)
//   gathers each byte with its own bounds test and stores 16 at a time;
// - the epilogue writes each accumulator with its own row and column
//   tests, so M, N and K need no multiple of the tile.
//
// MXTT_SKIP_LAST (a test build only): the K loop drops its last tile (in
// the wgmma route, the last of every split), the planted fault that the
// checks must catch.
//
// Each entry point returns cudaGetLastError() (or kBadSize for shapes it
// refuses), launches on the caller's stream and allocates nothing (split
// K's workspace is the caller's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output rows (pixels) a block
constexpr int kBN = 128;        // output columns (filters) a block
constexpr int kBK = 64;         // K bytes a stage
constexpr int kRow = kBK + 16;  // shared bytes a row: 80
constexpr int kThreads = 256;
constexpr int kBadSize = 100000;

constexpr int kEpiS32 = 0;
constexpr int kEpiF32 = 1;

struct Shape {
  int n, h, w, c;           // input, channels last
  int o, kh, kw;            // weight (o, kh, kw, cg)
  int p, q;                 // output spatial size
  int sh, sw, ph, pw, dh, dw;
  int cg, og;               // channels and filters a group
  int k;                    // kh * kw * cg
  long long m;              // n * p * q
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where one of a thread's two A rows reads from: the first byte of its
// image and group (-1: past M), and the top-left input position of its
// output pixel's window.
struct RowPos {
  long long base;
  int ih0, iw0;
};

__device__ __forceinline__ RowPos row_pos(const Shape& s, long long m,
                                          int group) {
  RowPos r;
  if (m >= s.m) {
    r.base = -1;
    r.ih0 = r.iw0 = 0;
    return r;
  }
  const long long pq = (long long)s.p * s.q;
  const long long img = m / pq;
  const int rem = (int)(m - img * pq);
  const int pp = rem / s.q;
  const int qq = rem - pp * s.q;
  r.base = img * s.h * s.w * s.c + (long long)group * s.cg;
  r.ih0 = pp * s.sh - s.ph;
  r.iw0 = qq * s.sw - s.pw;
  return r;
}

// The byte offset of input element (row r, kh tap, kw tap, channel cc),
// or -1 where it lies in the zero padding or past M.
__device__ __forceinline__ long long x_offset(const Shape& s, const RowPos& r,
                                              int tap_h, int tap_w, int cc) {
  if (r.base < 0) return -1;
  const int ih = r.ih0 + tap_h * s.dh;
  const int iw = r.iw0 + tap_w * s.dw;
  if (ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) return -1;
  return r.base + ((long long)ih * s.w + iw) * s.c + cc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ wt, void* __restrict__ out,
                     const void* __restrict__ bias, Shape s, int epilogue,
                     float denom) {
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's share of each stage: rows lr and lr + 64 of both
  // tiles, bytes [c16 * 16, c16 * 16 + 16) of the stage's 64
  const int lr = tid >> 2;
  const int c16 = tid & 3;
  RowPos rows[2];
  long long brow[2];   // first byte of the filter's row of w, -1: past O/G
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = row_pos(s, m0 + lr + 64 * i, group);
    const int j = n0 + lr + 64 * i;
    brow[i] = j < s.og ? (long long)(group * s.og + j) * s.k : -1;
  }

  auto load_stage = [&](int kt, int st) {
    const int k = kt * kBK + c16 * 16;
    if (kVec) {
      // 16 channels of one (kh, kw) tap: K and C/G are multiples of 16
      int tap = 0, cc = 0, tap_h = 0, tap_w = 0;
      const bool kin = k < s.k;
      if (kin) {
        tap = k / s.cg;
        cc = k - tap * s.cg;
        tap_h = tap / s.kw;
        tap_w = tap - tap_h * s.kw;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long off =
            kin ? x_offset(s, rows[i], tap_h, tap_w, cc) : -1;
        cp_async16(&sa[st][(lr + 64 * i) * kRow + c16 * 16],
                   off >= 0 ? x + off : x, off >= 0 ? 16 : 0);
        const bool bin = kin && brow[i] >= 0;
        cp_async16(&sb[st][(lr + 64 * i) * kRow + c16 * 16],
                   bin ? wt + brow[i] + k : wt, bin ? 16 : 0);
      }
    } else {
      unsigned av[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
      unsigned bv[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
      int tap = k / s.cg;
      int cc = k - tap * s.cg;
      int tap_h = tap / s.kw;
      int tap_w = tap - tap_h * s.kw;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (k + b < s.k) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const long long off = x_offset(s, rows[i], tap_h, tap_w, cc);
            if (off >= 0)
              av[i][b >> 2] |= (unsigned)(uint8_t)x[off] << ((b & 3) * 8);
            if (brow[i] >= 0)
              bv[i][b >> 2] |= (unsigned)(uint8_t)wt[brow[i] + k + b]
                               << ((b & 3) * 8);
          }
        }
        if (++cc == s.cg) {
          cc = 0;
          if (++tap_w == s.kw) {
            tap_w = 0;
            ++tap_h;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<uint4*>(&sa[st][(lr + 64 * i) * kRow + c16 * 16]) =
            make_uint4(av[i][0], av[i][1], av[i][2], av[i][3]);
        *reinterpret_cast<uint4*>(&sb[st][(lr + 64 * i) * kRow + c16 * 16]) =
            make_uint4(bv[i][0], bv[i][1], bv[i][2], bv[i][3]);
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int wm = (warp & 1) * 64;    // the warp's rows in the tile
  const int wn = (warp >> 1) * 32;   // its columns
  const int g8 = lane >> 2;
  const int t4 = lane & 3;

  int ktiles = (s.k + kBK - 1) / kBK;
#ifdef MXTT_SKIP_LAST
  ktiles -= 1;   // the planted fault: the last K tile is never summed
#endif
  if (ktiles > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_stage(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* A = sa[kt & 1];
    const int8_t* B = sb[kt & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = A + (wm + mi * 16 + g8) * kRow + ks + t4 * 4;
        const int8_t* r8 = r0 + 8 * kRow;
        af[mi][0] = *reinterpret_cast<const unsigned*>(r0);
        af[mi][1] = *reinterpret_cast<const unsigned*>(r8);
        af[mi][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(r8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = B + (wn + ni * 8 + g8) * kRow + ks + t4 * 4;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(c0);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }
  cp_async_wait_all();

  // epilogue: c0, c1 at row g8, columns 2 * t4 + {0, 1}; c2, c3 at row
  // g8 + 8 (the m16n8 accumulator's layout)
  const int* bias_i = static_cast<const int*>(bias);
  const float* bias_f = static_cast<const float*>(bias);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mi * 16 + g8 + 8 * half;
      if (m >= s.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n0 + wn + ni * 8 + t4 * 2 + e;
          if (j >= s.og) continue;
          const int oc = group * s.og + j;
          const int v = acc[mi][ni][half * 2 + e];
          const long long idx = m * s.o + oc;
          if (epilogue == kEpiS32) {
            const unsigned b = bias_i != nullptr ? (unsigned)bias_i[oc] : 0u;
            static_cast<int*>(out)[idx] = (int)((unsigned)v + b);
          } else {
            float f = __fdiv_rn(__int2float_rn(v), denom);
            if (bias_f != nullptr) f = __fadd_rn(f, bias_f[oc]);
            static_cast<float*>(out)[idx] = f;
          }
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// The wgmma route: m64nNk32 s8 products on 128-byte-swizzled tiles
// ---------------------------------------------------------------------------
//
// Work items are 128 x BN tiles of one group's output (two warpgroups of
// 64 rows, 256 threads) and one split of their K tiles, 128 K bytes a
// step: one 128-byte row of A (pixels) and of B (filters), laid out as
// TMA's 128-byte swizzle lays them (16-byte chunk c of row r at chunk
// c ^ (r % 8), tiles 1024-byte aligned), which wgmma reads as K-major
// operands.  Every thread loads and every thread computes:
//
// - one block an item; the grid's x runs the N tiles of one M tile back
//   to back, so that the blocks that run together share their A rows in
//   L2; 64-wide tiles run two blocks an SM, so that one block's loads
//   overlap the other's epilogue;
// - a ring of kStages steps; at step j the warpgroups issue wgmma on step
//   j, every thread then issues the loads of step j + S - 1 into the slot
//   that step j - 1 read, then waits for its wgmma; cp.async.wait_group
//   and one barrier a step order the ring (every thread both loads and
//   reads it, so an mbarrier would add an arrive to that barrier);
// - B (the OHWI weights, K-contiguous) by cp.async, 16 bytes a chunk
//   with zero fill past O / G or K; byte by byte where K is not a
//   multiple of 16 or the weights are misaligned (the stem's K of 147,
//   whose rows TMA cannot take: a tensor map's strides are multiples of
//   16 bytes);
// - A in one of three modes.  kAS8, s8 channels last (C/G a multiple of
//   16, 16-byte aligned): 16 channels of one tap a chunk by cp.async into
//   the ring, an implicit im2col.  kAF32Vec, the layer's f32 activation
//   with contiguous channels and 16-byte aligned chunks: each chunk is
//   four 16-byte loads.  kAF32Any, f32 of any strides and C/G (the stem's
//   3 channels, a channel-first view): element by element.  In both f32
//   modes a thread issues the loads of its share of the step (64 values;
//   the element path in four rounds of 16) before it uses the first,
//   then quantizes them in registers and stores them into the step's
//   slot with st.shared;
// - the quantize is the layers' rule: rintf(__fmul_rn(x, scale)) (half to
//   even), clamped to [-127, 127] (so +-inf give +-127); a NaN gives 0,
//   as the card's and XLA's float-to-int conversions do;
// - the epilogue stages the s32 tile in shared memory (the ring, drained
//   after the last step), then each warp writes whole output rows,
//   channels contiguous, 16 bytes a lane where O and O / G are multiples
//   of 4 (a 128-column f32 row is one 512-byte store of the warp), masked
//   by row and by column;
// - split K (grids of fewer tiles than SMs): each split writes its s32
//   partial tile into a workspace (kEpiRaw), and int8_splitk_reduce adds
//   the splits in s32 (exact in any order) and runs the epilogue once.
//
// What bounds it (tools/torch_int8_layers.py, H100 80GB HBM3 at 700 W):
// ResNet-50's stride-1 1 x 1 layers run at 23-86% of their byte bound;
// the 3 x 3 layers at 10-28%, bound by the L2 traffic of the implicit
// im2col (each input read once for each of the 9 taps and each N tile,
// four times the bytes in the f32 mode) and by the latency of each
// step's loads.  Tried
// and measured slower there: cp.async of the f32 activation into a 64
// KB-a-step staging ring quantized from shared memory (29.5 against
// 21.7 ms over ResNet-50's convolutions: twice the shared-memory
// traffic, and no L1 left for the re-reads); a persistent grid with the
// epilogue written from the registers (no faster than one block an
// item, and the register stores 2-3 times slower than the staged rows).

constexpr int kWgBM = 128;       // output rows a block: two warpgroups
constexpr int kWgBK = 128;       // K bytes a stage: one swizzled row
constexpr int kWgThreads = 256;
constexpr int kEpiRaw = 2;       // a split's s32 partial sums, no bias

constexpr int kAS8 = 0;
constexpr int kAF32Vec = 1;
constexpr int kAF32Any = 2;

// shared memory of the wgmma route: a ring of kStages A and B tiles (s8
// A by cp.async into its slot, f32 A quantized into it by st.shared);
// the epilogue's staging reuses it
template <int BN>
struct WgCfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kATile = kWgBM * kWgBK;           // 16 KB of s8
  static constexpr int kBTile = BN * kWgBK;
  static constexpr int kBRing = kStages * kBTile;
  static constexpr int kLoop = kBRing + kStages * kATile;
  static constexpr int kStgRow = BN + 8;     // epilogue staging row, words
  static constexpr int kStg = kWgBM * kStgRow * 4;
  static constexpr int kSmem = 1024 + (kLoop > kStg ? kLoop : kStg);
};

struct WgShape {
  Shape s;
  long long xs_n, xs_h, xs_w, xs_c;   // the input's strides, elements
  int ktiles, kper, splits, ntiles;   // K tiles, a split's, splits, N
  float scale;                        // tiles of a group; A's scale
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  // K-major, 128-byte swizzle: sbo 1024 (8 rows of 128 bytes), lbo
  // unused (16), layout type 1 in bits 62-63
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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

template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define MXTT_I8(i)                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x N, s32) += a b; a and b s8 in shared memory, both K-major,
// 128-byte swizzled.  Register i of a thread (lane 4 g + t, warp w of
// the warpgroup) holds row 16 w + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 t + (i & 1).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : MXTT_I8(0), MXTT_I8(8), MXTT_I8(16), MXTT_I8(24)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : MXTT_I8(0), MXTT_I8(8), MXTT_I8(16), MXTT_I8(24),
        MXTT_I8(32), MXTT_I8(40), MXTT_I8(48), MXTT_I8(56)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : MXTT_I8(0), MXTT_I8(8), MXTT_I8(16), MXTT_I8(24),
        MXTT_I8(32), MXTT_I8(40), MXTT_I8(48), MXTT_I8(56),
        MXTT_I8(64), MXTT_I8(72), MXTT_I8(80), MXTT_I8(88),
        MXTT_I8(96), MXTT_I8(104), MXTT_I8(112), MXTT_I8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef MXTT_I8

// the layers' quantize of one f32 value, as a byte
__device__ __forceinline__ uint32_t quant8(float x, float scale) {
  float v = rintf(__fmul_rn(x, scale));
  if (v != v) return 0u;   // NaN
  v = fminf(fmaxf(v, -127.f), 127.f);
  return (uint32_t)(__float2int_rn(v) & 0xff);
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d,
                                           float scale) {
  return quant8(a, scale) | quant8(b, scale) << 8 | quant8(c, scale) << 16 |
         quant8(d, scale) << 24;
}

// where one A row of the new route reads from: the element offset of its
// image's (and group's) first channel (-1: past M), and its window's
// top-left input position
struct WgRow {
  long long base;
  int ih0, iw0;
};

__device__ __forceinline__ WgRow wg_row(const WgShape& g, long long m,
                                        int group) {
  const Shape& s = g.s;
  WgRow r;
  if (m >= s.m) {
    r.base = -1;
    r.ih0 = r.iw0 = 0;
    return r;
  }
  const long long pq = (long long)s.p * s.q;
  const long long img = m / pq;
  const int rem = (int)(m - img * pq);
  const int pp = rem / s.q;
  const int qq = rem - pp * s.q;
  r.base = img * g.xs_n + (long long)group * s.cg * g.xs_c;
  r.ih0 = pp * s.sh - s.ph;
  r.iw0 = qq * s.sw - s.pw;
  return r;
}

// the element offset of (row, tap, channel), or -1 in the padding or
// past M
__device__ __forceinline__ long long wg_offset(const WgShape& g,
                                               const WgRow& r, int tap_h,
                                               int tap_w, int cc) {
  const Shape& s = g.s;
  if (r.base < 0) return -1;
  const int ih = r.ih0 + tap_h * s.dh;
  const int iw = r.iw0 + tap_w * s.dw;
  if (ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) return -1;
  return r.base + ih * g.xs_h + iw * g.xs_w + cc * g.xs_c;
}

// K index k as (tap row, tap column, channel); false past K
__device__ __forceinline__ bool k_tap(const Shape& s, int k, int& tap_h,
                                      int& tap_w, int& cc) {
  if (k >= s.k) {
    tap_h = tap_w = cc = 0;
    return false;
  }
  const int tap = k / s.cg;
  cc = k - tap * s.cg;
  tap_h = tap / s.kw;
  tap_w = tap - tap_h * s.kw;
  return true;
}

// the shared address of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw_chunk(uint32_t tile, int r, int c) {
  return tile + r * kWgBK + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}

// one output value of the epilogue, from the s32 sum v of column oc
__device__ __forceinline__ void put_out(void* out, long long idx, int v,
                                        int oc, int epilogue,
                                        const void* bias, float denom) {
  if (epilogue == kEpiF32) {
    float f = __fdiv_rn(__int2float_rn(v), denom);
    if (bias != nullptr) f = __fadd_rn(f, static_cast<const float*>(bias)[oc]);
    static_cast<float*>(out)[idx] = f;
  } else {
    unsigned u = (unsigned)v;
    if (epilogue == kEpiS32 && bias != nullptr)
      u += (unsigned)static_cast<const int*>(bias)[oc];
    static_cast<int*>(out)[idx] = (int)u;
  }
}

// a work item of the wgmma route: one tile of one group's output and
// one split of its K tiles; items run N tiles of one M tile back to back
struct WgItem {
  long long m0;
  int n0, group, split, kt0, nk;
};

template <int BN>
__device__ __forceinline__ WgItem wg_item(const WgShape& g, long long w) {
  WgItem it;
  const int nt = (int)(w % g.ntiles);
  long long r = w / g.ntiles;
  it.split = (int)(r % g.splits);
  r /= g.splits;
  const int groups = g.s.o / g.s.og;
  it.group = (int)(r % groups);
  it.m0 = (r / groups) * kWgBM;
  it.n0 = nt * BN;
  it.kt0 = it.split * g.kper;
  int kt1 = min(g.ktiles, it.kt0 + g.kper);
#ifdef MXTT_SKIP_LAST
  kt1 -= 1;   // the planted fault: each split's last K tile is never summed
#endif
  it.nk = max(kt1 - it.kt0, 0);
  return it;
}

// The wgmma kernel: block b takes work item b.  64-wide tiles (96 KB of
// ring) run two blocks an SM, so one block's loads overlap the other's.
template <int BN, int AMODE>
__global__ void __launch_bounds__(kWgThreads, BN == 64 ? 2 : 1)
    int8_wgmma_kernel(const void* __restrict__ xv,
                      const int8_t* __restrict__ wt, void* __restrict__ out,
                      const void* __restrict__ bias, WgShape g, int epilogue,
                      float denom, int b_vec, int out_vec) {
  using C = WgCfg<BN>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t b_ring = base;
  const uint32_t a_ring = base + C::kBRing;
  const Shape& s = g.s;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // this thread's share of a step: 16-byte chunk c8 of rows lr + 32 i
  const int lr = tid >> 3;
  const int c8 = tid & 7;
  const int8_t* x8 = static_cast<const int8_t*>(xv);
  const float* xf = static_cast<const float*>(xv);
  auto sp = [&](uint32_t addr) { return wg_smem + (addr - raw); };

  const WgItem it = wg_item<BN>(g, blockIdx.x);
  WgRow rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    rows[i] = wg_row(g, it.m0 + lr + 32 * i, it.group);
  const long long wbase = (long long)it.group * s.og * s.k;

  // the loads of step `step` (K tile it.kt0 + step) into ring slot
  // step % S: B and s8 A by cp.async; f32 A loaded, every load of the
  // thread's share issued before the first is used, quantized and stored
  auto produce = [&](int step) {
    if (step < it.nk) {
      const int slot = step % S;
      const uint32_t at = a_ring + slot * C::kATile;
      const int kt = it.kt0 + step;
      const int k = kt * kWgBK + c8 * 16;
      const uint32_t bt = b_ring + slot * C::kBTile;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int r = lr + 32 * i;
        const bool nin = it.n0 + r < s.og;
        const long long src = wbase + (long long)(it.n0 + r) * s.k + k;
        if (b_vec) {
          const bool in = nin && k < s.k;
          cp_async16(sp(sw_chunk(bt, r, c8)), in ? wt + src : wt,
                     in ? 16 : 0);
        } else {
          uint32_t bw[4] = {0u, 0u, 0u, 0u};
          if (nin) {
#pragma unroll
            for (int b = 0; b < 16; ++b)
              if (k + b < s.k)
                bw[b >> 2] |= (uint32_t)(uint8_t)wt[src + b] << ((b & 3) * 8);
          }
          st_shared_v4(sw_chunk(bt, r, c8), bw[0], bw[1], bw[2], bw[3]);
        }
      }
      if constexpr (AMODE == kAS8 || AMODE == kAF32Vec) {
        // 16 channels of one tap: C/G and K are multiples of 16
        int tap_h, tap_w, cc;
        const bool kin = k_tap(s, k, tap_h, tap_w, cc);
        long long off[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          off[i] = kin ? wg_offset(g, rows[i], tap_h, tap_w, cc) : -1;
        if constexpr (AMODE == kAS8) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cp_async16(sp(sw_chunk(at, lr + 32 * i, c8)),
                       off[i] >= 0 ? x8 + off[i] : x8, off[i] >= 0 ? 16 : 0);
        } else {
          float4 v[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4* p = reinterpret_cast<const float4*>(
                xf + (off[i] >= 0 ? off[i] : 0));
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[i][j] = off[i] >= 0 ? __ldg(p + j)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              q[j] = quant4(v[i][j].x, v[i][j].y, v[i][j].z, v[i][j].w,
                            g.scale);
            st_shared_v4(sw_chunk(at, lr + 32 * i, c8), q[0], q[1], q[2],
                         q[3]);
          }
        }
      } else {
        // element by element: word c8 + 8 jw of each row, 4 K indices,
        // in four rounds of 16 loads (all 64 at once measured slower)
#pragma unroll 1
        for (int jw = 0; jw < 4; ++jw) {
          const int wd = c8 + 8 * jw;
          int th[4], tw[4], tc[4];
          bool ok[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ok[e] = k_tap(s, kt * kWgBK + 4 * wd + e, th[e], tw[e], tc[e]);
          float v[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const long long off =
                  ok[e] ? wg_offset(g, rows[i], th[e], tw[e], tc[e]) : -1;
              v[i][e] = off >= 0 ? __ldg(xf + off) : 0.f;
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            st_shared_b32(sw_chunk(at, lr + 32 * i, wd >> 2) + (wd & 3) * 4,
                          quant4(v[i][0], v[i][1], v[i][2], v[i][3],
                                 g.scale));
        }
      }
    }
    cp_async_commit();
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll 1
  for (int step = 0; step < S - 1; ++step) produce(step);
#pragma unroll 1
  for (int i = 0; i < it.nk; ++i) {
    cp_async_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    const uint32_t at = a_ring + (i % S) * C::kATile + wg * 64 * kWgBK;
    const uint32_t bt = b_ring + (i % S) * C::kBTile;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk)
      wgmma_s8<BN>(acc, sw128_desc(at + 32 * kk), sw128_desc(bt + 32 * kk));
    wg_commit();
    produce(i + S - 1);
    wg_wait_all();
    reg_fence(acc);
  }
  cp_async_wait_all();
  __syncthreads();

  // stage the s32 tile (the ring is free), then write whole rows,
  // channels contiguous: 16 bytes a lane where O and O / G are multiples
  // of 4, masked by row and by column
  int* stg = reinterpret_cast<int*>(sp(base));
  {
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int r = 64 * wg + 16 * warp + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      *reinterpret_cast<int2*>(&stg[r * C::kStgRow + 8 * jn + c]) =
          make_int2(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<int2*>(&stg[(r + 8) * C::kStgRow + 8 * jn + c]) =
          make_int2(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
  }
  __syncthreads();
  constexpr int kLanesRow = BN / 4 < 32 ? BN / 4 : 32;
  constexpr int kRowsPass = 32 / kLanesRow;
  const int lane = tid & 31;
  const int lrow = lane / kLanesRow, lcol = 4 * (lane % kLanesRow);
  void* dst = out;
  if (epilogue == kEpiRaw)
    dst = static_cast<int*>(out) + (long long)it.split * s.m * s.o;
#pragma unroll 1
  for (int r = (tid >> 5) * kRowsPass + lrow; r < kWgBM;
       r += (kWgThreads / 32) * kRowsPass) {
    const long long m = it.m0 + r;
    if (m >= s.m) break;
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += 4 * kLanesRow) {
      const int col = c0 + lcol;
      const int j = it.n0 + col;
      if (j >= s.og) continue;
      const int4 v =
          *reinterpret_cast<const int4*>(&stg[r * C::kStgRow + col]);
      const int oc = it.group * s.og + j;
      const long long idx = m * s.o + oc;
      if (out_vec && j + 3 < s.og) {
        if (epilogue == kEpiF32) {
          float f[4] = {__fdiv_rn(__int2float_rn(v.x), denom),
                        __fdiv_rn(__int2float_rn(v.y), denom),
                        __fdiv_rn(__int2float_rn(v.z), denom),
                        __fdiv_rn(__int2float_rn(v.w), denom)};
          if (bias != nullptr) {
            const float* bf = static_cast<const float*>(bias) + oc;
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = __fadd_rn(f[e], bf[e]);
          }
          *reinterpret_cast<float4*>(static_cast<float*>(dst) + idx) =
              make_float4(f[0], f[1], f[2], f[3]);
        } else {
          unsigned u[4] = {(unsigned)v.x, (unsigned)v.y, (unsigned)v.z,
                           (unsigned)v.w};
          if (epilogue == kEpiS32 && bias != nullptr) {
            const int* bi = static_cast<const int*>(bias) + oc;
#pragma unroll
            for (int e = 0; e < 4; ++e) u[e] += (unsigned)bi[e];
          }
          *reinterpret_cast<int4*>(static_cast<int*>(dst) + idx) =
              make_int4((int)u[0], (int)u[1], (int)u[2], (int)u[3]);
        }
      } else {
        const int vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < s.og)
            put_out(dst, idx + e, vv[e], oc + e, epilogue, bias, denom);
      }
    }
  }
}

// the splits' s32 partial sums (splits x M x O) added in s32, then the
// epilogue, once an output element
__global__ void int8_splitk_reduce(const int* __restrict__ ws,
                                   void* __restrict__ out,
                                   const void* __restrict__ bias,
                                   long long mo, int o, int splits,
                                   int epilogue, float denom) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < mo; i += (long long)gridDim.x * blockDim.x) {
    unsigned acc = 0u;
    for (int sp = 0; sp < splits; ++sp) acc += (unsigned)ws[sp * mo + i];
    put_out(out, i, (int)acc, (int)(i % o), epilogue, bias, denom);
  }
}

template <int BN, int AMODE>
int launch_wgmma(const void* x, const int8_t* wt, void* out, void* ws,
                 const void* bias, const WgShape& g, int epilogue,
                 float denom, int b_vec, int out_vec, cudaStream_t st) {
  using C = WgCfg<BN>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_wgmma_kernel<BN, AMODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long mt = (g.s.m + kWgBM - 1) / kWgBM;
  const long long items =
      mt * (g.s.o / g.s.og) * (long long)g.splits * g.ntiles;
  if (items > 0x7fffffffLL) return kBadSize;
  const bool split = g.splits > 1;
  int8_wgmma_kernel<BN, AMODE><<<(unsigned)items, kWgThreads, C::kSmem,
                                 st>>>(x, wt, split ? ws : out, bias, g,
                                       split ? kEpiRaw : epilogue, denom,
                                       b_vec, out_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const long long mo = g.s.m * g.s.o;
  const long long rb = (mo + 255) / 256;
  int8_splitk_reduce<<<(unsigned)(rb < 4096 ? rb : 4096), 256, 0, st>>>(
      static_cast<const int*>(ws), out, bias, mo, g.s.o, g.splits, epilogue,
      denom);
  return (int)cudaGetLastError();
}

}  // namespace

// O6's mma_sync route.  x: (n, h, w, c) s8; wt: (o, kh, kw, c / groups)
// s8; out: (n, p, q, o) s32 (epilogue 0) or f32 (epilogue 1); bias: (o,)
// s32 or f32, or null.  p and q are the output's spatial size, which the
// caller derives from the stride, padding and dilation.
extern "C" int mxtt_int8_conv(const void* x, const void* wt, void* out,
                              const void* bias, int n, int h, int w, int c,
                              int o, int kh, int kw, int p, int q, int sh,
                              int sw, int ph, int pw, int dh, int dw,
                              int groups, int epilogue, float denom,
                              void* stream) {
  if (groups <= 0 || c % groups != 0 || o % groups != 0) return kBadSize;
  if (epilogue != kEpiS32 && epilogue != kEpiF32) return kBadSize;
  Shape s;
  s.n = n; s.h = h; s.w = w; s.c = c;
  s.o = o; s.kh = kh; s.kw = kw;
  s.p = p; s.q = q;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  s.cg = c / groups;
  s.og = o / groups;
  s.k = kh * kw * s.cg;
  s.m = (long long)n * p * q;
  if (s.m <= 0 || s.og <= 0) return 0;
  const long long mt = (s.m + kBM - 1) / kBM;
  const long long nt = (s.og + kBN - 1) / kBN;
  if (mt > 0x7fffffffLL || nt > 65535 || groups > 65535) return kBadSize;
  const bool vec = s.cg % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  const dim3 grid((unsigned)mt, (unsigned)nt, (unsigned)groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  if (vec)
    int8_conv_kernel<true><<<grid, kThreads, 0, st>>>(xp, wp, out, bias, s,
                                                      epilogue, denom);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, st>>>(xp, wp, out, bias, s,
                                                       epilogue, denom);
  return (int)cudaGetLastError();
}

// O5.  a: (m, k) s8; b: (n, k) s8; out: (m, n) s32 or f32; bias: (n,) or
// null.  The same kernel as O6 at 1 x 1 x 1 x 1.
extern "C" int mxtt_int8_gemm(const void* a, const void* b, void* out,
                              const void* bias, int m, int n, int k,
                              int epilogue, float denom, void* stream) {
  return mxtt_int8_conv(a, b, out, bias, m, 1, 1, k, n, 1, 1, 1, 1, 1, 1, 0,
                        0, 1, 1, 1, epilogue, denom, stream);
}

// The wgmma route of O6 (O5 is its 1 x 1 case).  x: (n, h, w, c) with
// element strides xs_*, s8 (a_mode kAS8) or f32 (kAF32Vec, kAF32Any;
// quantized by `scale` as it loads); wt: (o, kh, kw, c / groups) s8,
// contiguous; out as mxtt_int8_conv's.  bn (64, 128 or 256; 128 at most
// for f32) is the tile's width and splits the K splits, whose s32
// partial sums go to ws (splits x m x o s32; null for one split).
extern "C" int mxtt_int8_conv_wgmma(
    const void* x, int a_mode, float scale, long long xs_n, long long xs_h,
    long long xs_w, long long xs_c, const void* wt, void* out, void* ws,
    const void* bias, int n, int h, int w, int c, int o, int kh, int kw,
    int p, int q, int sh, int sw, int ph, int pw, int dh, int dw, int groups,
    int bn, int splits, int epilogue, float denom, void* stream) {
  if (groups <= 0 || c % groups != 0 || o % groups != 0) return kBadSize;
  if (epilogue != kEpiS32 && epilogue != kEpiF32) return kBadSize;
  WgShape g;
  Shape& s = g.s;
  s.n = n; s.h = h; s.w = w; s.c = c;
  s.o = o; s.kh = kh; s.kw = kw;
  s.p = p; s.q = q;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  s.cg = c / groups;
  s.og = o / groups;
  s.k = kh * kw * s.cg;
  s.m = (long long)n * p * q;
  if (s.m <= 0 || s.og <= 0) return 0;
  g.xs_n = xs_n; g.xs_h = xs_h; g.xs_w = xs_w; g.xs_c = xs_c;
  g.scale = scale;
  g.ktiles = (s.k + kWgBK - 1) / kWgBK;
  g.splits = splits;
  g.kper = splits > 0 ? (g.ktiles + splits - 1) / splits : 0;
  g.ntiles = (s.og + bn - 1) / bn;
  // every split holds at least one K tile; a split needs its workspace
  if (splits <= 0 || (long long)(splits - 1) * g.kper >= g.ktiles ||
      (splits > 1 && ws == nullptr))
    return kBadSize;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool chunked = s.cg % 16 == 0 && xs_c == 1 && (xa & 15) == 0;
  if (a_mode == kAS8 && !chunked) return kBadSize;
  if (a_mode == kAF32Vec &&
      !(chunked && xs_n % 4 == 0 && xs_h % 4 == 0 && xs_w % 4 == 0))
    return kBadSize;
  if (a_mode != kAS8 && a_mode != kAF32Vec && a_mode != kAF32Any)
    return kBadSize;
  const int b_vec =
      s.k % 16 == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  // 16-byte stores of four columns where every such store is aligned
  const int out_vec =
      o % 4 == 0 && s.og % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(splits > 1 ? ws : out) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(wt);
#define MXTT_LAUNCH(BN, MODE)                                              \
  return launch_wgmma<BN, MODE>(x, wp, out, ws, bias, g, epilogue, denom,  \
                                b_vec, out_vec, st)
  if (a_mode == kAS8) {
    if (bn == 64) MXTT_LAUNCH(64, kAS8);
    if (bn == 128) MXTT_LAUNCH(128, kAS8);
    if (bn == 256) MXTT_LAUNCH(256, kAS8);
  } else if (a_mode == kAF32Vec) {
    if (bn == 64) MXTT_LAUNCH(64, kAF32Vec);
    if (bn == 128) MXTT_LAUNCH(128, kAF32Vec);
    if (bn == 256) MXTT_LAUNCH(256, kAF32Vec);
  } else {
    if (bn == 64) MXTT_LAUNCH(64, kAF32Any);
    if (bn == 128) MXTT_LAUNCH(128, kAF32Any);
    if (bn == 256) MXTT_LAUNCH(256, kAF32Any);
  }
#undef MXTT_LAUNCH
  return kBadSize;
}

extern "C" const char* mxtt_int8_error_string(int err) {
  if (err == kBadSize) return "a shape or argument the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
