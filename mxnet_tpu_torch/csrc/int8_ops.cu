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
// them write about 9 GB, a bound of 4.14 ms of which 0.27 ms is
// operations (chip_smoke.py's quant phase).  So the tile's loads are
// kept simple, and its output, written once, is what the time buys.
//
// Design (simple first; wgmma with s8 operands and TMA are later work).
// - A block of 256 threads takes a 128 x 128 tile of one group's output
//   and walks K in steps of 64 bytes through two stages of shared memory.
//   Its 8 warps each hold a 64 x 32 tile in registers as 4 x 4
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 accumulators.
// - Shared rows are 80 bytes (64 + 16 of padding), so the 32-bit fragment
//   reads of a warp's 8 rows x 4 words fall on 32 distinct banks.
// - The vector path (C / G a multiple of 16 and both operands 16-byte
//   aligned): each thread copies 16-byte chunks with cp.async, which
//   fills a chunk that lies in the padding, past K or past M with zeros.
//   A chunk of 16 channels never crosses a (kh, kw) position.
// - The byte path (anything else: the stem's 3 channels, depthwise and
//   odd group widths, K tails not a multiple of 16, misaligned views)
//   gathers each byte with its own bounds test and stores 16 at a time.
// - The epilogue writes each accumulator with its own row and column
//   tests, so M, N and K need no multiple of the tile.
//
// MXTT_SKIP_LAST (a test build only): the K loop drops its last tile,
// the planted fault that the checks must catch.
//
// Each entry point returns cudaGetLastError() (or kBadSize for shapes it
// refuses), launches on the caller's stream and allocates nothing.

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

}  // namespace

// O6.  x: (n, h, w, c) s8; wt: (o, kh, kw, c / groups) s8; out: (n, p, q,
// o) s32 (epilogue 0) or f32 (epilogue 1); bias: (o,) s32 or f32, or
// null.  p and q are the output's spatial size, which the caller derives
// from the stride, padding and dilation.
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

extern "C" const char* mxtt_int8_error_string(int err) {
  if (err == kBadSize) return "a shape or argument the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
