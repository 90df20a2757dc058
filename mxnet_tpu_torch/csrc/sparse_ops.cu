// Sparse storage kernels for Hopper (sm_90a): O7 csr_dot and O8
// rsp_lazy_update.
//
// No Pallas kernel stands behind these.  The JAX package keeps its sparse
// arrays as structured dense pairs and lets XLA fuse their gathers and
// scatters into one executable: sparse.dot (mxnet_tpu/ndarray/sparse.py:408)
// is a gather, a product and a scatter-add over the nonzeros, and the lazy
// update (mxnet_tpu/optimizer/optimizer.py:170, _get_sparse_jit_step) a
// gather of the touched rows, the optimizer's step and a scatter.  Eager
// PyTorch would launch a kernel for each of those ops and write each
// intermediate to device memory; each kernel here is one launch.
//
// Bound.  Both are bound by bytes: a csr_dot reads the values, the
// column indices, indptr and one rhs row a nonzero, and writes the
// output; a lazy update reads and writes the listed rows of the weight
// and of each state, and reads the gradient rows and their indices.
// Nothing is reused, so each byte is read once, in coalesced loads where
// the layout allows.
//
// O7 csr_dot, f32, indices int64 (the port's 64-bit rule).
// - out = A . rhs, K 1: L lanes a row (L a power of two fitted by the
//   host to the mean row length: 8 at 22 nonzeros), so a warp serves
//   32 / L rows.  Each lane loads up to four (column, value) pairs,
//   then issues their four rhs gathers through the read-only path
//   before the first use, then sums; the L lanes reduce with xor
//   shuffles.  No atomics: two runs are bitwise equal.
// - out = A . rhs, K > 1: a warp a row.  The lanes load 32 of the row's
//   (column, value) pairs at once and broadcast them by shuffles; each
//   lane owns four adjacent output columns (float4 rhs loads and stores
//   where K % 4 == 0 and rhs and out are 16-byte aligned), else one.
//   The sums run in the row's order: bitwise repeatable.
// - out = A^T . rhs: a scatter by column, which CTR batches skew: a
//   field's most common id can sit in a quarter of the rows, and a
//   global atomic a nonzero queues thousands of adds on one address at
//   its L2 slice.  So a block takes a tile of 32 consecutive rows, a lane
//   a row, and its warps split the nonzeros' positions j (warp w the j
//   in its share of the tile's longest row): a warp step holds the j-th
//   nonzero of 32 rows, which in a CTR batch is one field of 32 rows.
//   Equal columns among the 32 are found with __match_any_sync and
//   combined before anything reaches device memory: the group's lowest
//   lane sums the group's products (K 1), or the warp sums the group's
//   rhs rows with its lanes over K (float4 where aligned); then one
//   red.global.add (vector red for float4) a distinct column.  Each lane
//   loads four (column, value) pairs before their first use, through the
//   read-only path.  A hot column takes one global add a tile (256 at
//   the CTR cell's 8,192 rows) where it took one a nonzero.  (A
//   block-wide hash table in shared memory over a tile of rows was
//   slower: its inserts' latency cost more than the adds it saved.)
//   The output is zeroed first by a cudaMemsetAsync on the same stream;
//   the kernel's grid is one block a tile.  The sums' order changes from
//   run to run.
// - Every product is rounded before it is summed (__fmul_rn, then
//   __fadd_rn or an atomic add), as the plain version's product-then-
//   index_add_ rounds it; only the order of the sums differs.  A column
//   index outside [0, N) is skipped.
//
// O8 rsp_lazy_update, f32: a compacted row-sparse gradient (unique row
// indices (U,), values (U, C)) updates the listed rows of the weight and
// of its state in place; no other row is read or written.  One thread an
// element, grid-stride.  The routes are the port's optimizers' own steps,
// with lr and the update count read by pointer from the device as O1 and
// O2 read them:
// - 0 SGD and 1 SGD with momentum: O2's arithmetic (sgd_elem in
//   optimizer_ops.cu), fused multiply-adds where torch's add(alpha)
//   takes one;
// - 2 Adam: O1's class form with wd folded into the gradient
//   (adam_elem), beta^t the powf of the count as an f32;
// - 3 AdaGrad: optimizer.AdaGrad's torch formula, op by op:
//   g += wd*w, hist += g*g, w -= lr*g / sqrt(hist + eps).
// The arithmetic goes through the _rn intrinsics, which are never
// contracted, so each result is the one the plain version (gather, the
// optimizer's step on the rows, index_copy_) gives on the card.  A row
// index outside [0, n) is skipped on the device.
//
// Each entry point launches on the caller's stream, returns
// cudaGetLastError() (or kBadArgs) and writes the number of kernels it
// launched to *launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;      // grid-stride beyond this
constexpr int kBadArgs = -1;

__device__ __forceinline__ float clip(float g, float c) {
  // NaN passes through, as torch.clamp gives it
  return g < -c ? -c : (g > c ? c : g);
}

// ---------------------------------------------------------------------------
// O7 csr_dot
// ---------------------------------------------------------------------------

constexpr int kUnroll = 4;                 // nonzeros a lane loads at once
constexpr unsigned kEmpty = 0xffffffffu;   // no column (skipped, or none)

struct CsrArgs {
  const float* data;        // (nnz,) values
  const long long* indptr;  // (m + 1,)
  const long long* cols;    // (nnz,) column indices
  const float* rhs;         // (n, kdim), or (m, kdim) transposed
  float* out;               // (m, kdim), or (n, kdim) transposed
  long long m, n, kdim;
  int vec4;                 // kdim % 4 == 0, rhs and out 16-byte aligned
};

__device__ __forceinline__ void red_add(float* addr, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(addr), "f"(v)
               : "memory");
}

// four adjacent floats added at once (sm_90's vector red); addr 16-byte
// aligned
__device__ __forceinline__ void red_add4(float* addr, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 fma4(float4 acc, float v, float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v, x.w));
  return acc;
}

// out (m, 1) = A . rhs (n, 1): L lanes a row
template <int L>
__global__ void __launch_bounds__(kThreads)
    csr_dot_k1_kernel(const __grid_constant__ CsrArgs p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const int lane = threadIdx.x & (L - 1);
  float acc = 0.f;
  if (row < p.m) {
    const long long lo = __ldg(p.indptr + row);
    const long long hi = __ldg(p.indptr + row + 1);
    for (long long k0 = lo + lane; k0 < hi; k0 += kUnroll * L) {
      long long c[kUnroll];
      float d[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = k0 + u * L;
        c[u] = k < hi ? __ldg(p.cols + k) : -1;
        d[u] = k < hi ? __ldg(p.data + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        r[u] = (c[u] >= 0 && c[u] < p.n) ? __ldg(p.rhs + c[u]) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c[u] >= 0 && c[u] < p.n)
          acc = __fadd_rn(acc, __fmul_rn(d[u], r[u]));
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (row < p.m && lane == 0) p.out[row] = acc;
}

// out (m, kdim) = A . rhs (n, kdim): a warp a row, VEC: float4 columns
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    csr_dot_rows_kernel(const __grid_constant__ CsrArgs p) {
  constexpr int kCols = VEC ? 4 : 1;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= p.m) return;                 // the whole warp leaves
  const long long lo = p.indptr[row], hi = p.indptr[row + 1];
  for (long long b = 0; b < p.kdim; b += 32 * kCols) {
    const long long col = b + lane * kCols;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long k0 = lo; k0 < hi; k0 += 32) {
      const long long k = k0 + lane;
      const long long mine = k < hi ? p.cols[k] : -1;
      const float mine_v = k < hi ? p.data[k] : 0.f;
      const int cnt = static_cast<int>(hi - k0 < 32 ? hi - k0 : 32);
      for (int j = 0; j < cnt; ++j) {
        const long long c = __shfl_sync(0xffffffffu, mine, j);
        const float v = __shfl_sync(0xffffffffu, mine_v, j);
        if (c < 0 || c >= p.n || col >= p.kdim) continue;
        if (VEC) {
          acc = fma4(acc, v, __ldg(reinterpret_cast<const float4*>(
                                 p.rhs + c * p.kdim + col)));
        } else {
          acc.x = __fadd_rn(acc.x,
                            __fmul_rn(v, __ldg(p.rhs + c * p.kdim + col)));
        }
      }
    }
    if (col < p.kdim) {
      if (VEC)
        *reinterpret_cast<float4*>(p.out + row * p.kdim + col) = acc;
      else
        p.out[row * p.kdim + col] = acc.x;
    }
  }
}

// A lane's row of a transposed tile: its nonzeros [lo, lo + len), its rhs
// value (K 1), and the warp's share [j_lo, j_hi) of the positions j.
struct TileRow {
  long long row, lo, len, j_lo, j_hi;
  float r;
};

__device__ __forceinline__ TileRow tile_row(const CsrArgs& p, long long tile,
                                            int lane, int warp, bool k1) {
  TileRow t;
  t.row = tile * 32 + lane;
  t.lo = t.len = 0;
  t.r = 0.f;
  if (t.row < p.m) {
    t.lo = p.indptr[t.row];
    t.len = p.indptr[t.row + 1] - t.lo;
    if (k1) t.r = p.rhs[t.row];
  }
  long long most = t.len;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(0xffffffffu, most, off);
    most = o > most ? o : most;
  }
  const long long per = (most + kWarps - 1) / kWarps;
  t.j_lo = warp * per;
  t.j_hi = t.j_lo + per < most ? t.j_lo + per : most;
  return t;
}

// the (column, value) pairs at positions j0 .. j0 + kUnroll - 1 of a
// lane's row, loaded before their first use; kEmpty for none or a
// column outside [0, n)
__device__ __forceinline__ void load_pairs(const CsrArgs& p,
                                           const TileRow& t, long long j0,
                                           unsigned* key, float* d) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = j0 + u;
    const bool in = j < t.j_hi && j < t.len;
    const long long c = in ? __ldg(p.cols + t.lo + j) : -1;
    d[u] = in ? __ldg(p.data + t.lo + j) : 0.f;
    key[u] = c >= 0 && c < p.n ? static_cast<unsigned>(c) : kEmpty;
  }
}

// out (n, kdim) = A^T . rhs (m, kdim).  A block takes a tile of 32 rows,
// a lane a row; warp w walks its share of the j-th nonzeros of all 32
// rows (j in [w * per, (w + 1) * per), per = the tile's longest row /
// kWarps), so a warp step meets one field of 32 rows.  Lanes whose
// columns match (__match_any_sync) are one group: its lowest lane adds
// the group's sum once.  KMODE 0: K 1; 1: K > 1, a lane a column; 2:
// K > 1, four adjacent columns a lane (float4).  One block a tile.
template <int KMODE>
__global__ void __launch_bounds__(kThreads)
    csr_dot_t_kernel(const __grid_constant__ CsrArgs p) {
  __shared__ float s_val[kWarps][32];     // each lane's value (K 1) or
  __shared__ long long s_row[kWarps][32]; // nonzero's value and row (K > 1)
  constexpr int kCols = KMODE == 2 ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sv = s_val[warp];
  long long* sr = s_row[warp];
  const TileRow t = tile_row(p, blockIdx.x, lane, warp, KMODE == 0);
  unsigned key[kUnroll];
  float d[kUnroll];
  for (long long j0 = t.j_lo; j0 < t.j_hi; j0 += kUnroll) {
    load_pairs(p, t, j0, key, d);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u >= t.j_hi) break;      // the same for the whole warp
      const unsigned mask = __match_any_sync(0xffffffffu, key[u]);
      const bool lead = key[u] != kEmpty && lane == __ffs(mask) - 1;
      if (KMODE == 0) {
        const float v = __fmul_rn(d[u], t.r);
        sv[lane] = v;
        __syncwarp();
        if (lead) {
          float sum = v;
          for (unsigned g = mask & (mask - 1); g; g &= g - 1)
            sum = __fadd_rn(sum, sv[__ffs(g) - 1]);
          red_add(p.out + key[u], sum);
        }
      } else {
        sv[lane] = d[u];
        sr[lane] = t.row;
        __syncwarp();
        // the warp takes the groups one by one, its lanes over K
        for (unsigned leads = __ballot_sync(0xffffffffu, lead); leads;
             leads &= leads - 1) {
          const int l = __ffs(leads) - 1;
          const unsigned group = __shfl_sync(0xffffffffu, mask, l);
          const unsigned col = __shfl_sync(0xffffffffu, key[u], l);
          float* o = p.out + static_cast<long long>(col) * p.kdim;
          for (long long c0 = lane * kCols; c0 < p.kdim;
               c0 += 32 * kCols) {
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
            for (unsigned g = group; g; g &= g - 1) {
              const int b = __ffs(g) - 1;
              const float* x = p.rhs + sr[b] * p.kdim + c0;
              if (KMODE == 2)
                acc = fma4(acc, sv[b],
                           __ldg(reinterpret_cast<const float4*>(x)));
              else
                acc.x = __fadd_rn(acc.x, __fmul_rn(sv[b], __ldg(x)));
            }
            if (KMODE == 2)
              red_add4(o + c0, acc);
            else
              red_add(o + c0, acc.x);
          }
        }
      }
      __syncwarp();                     // before the next step's writes
    }
  }
}

// ---------------------------------------------------------------------------
// O8 rsp_lazy_update
// ---------------------------------------------------------------------------

struct LazyArgs {
  float* w;                 // (n, c) weight, updated in place
  const float* g;           // (u, c) gradient rows
  const long long* idx;     // (u,) their row indices, unique
  float* s0;                // momentum, Adam's mean, AdaGrad's history
  float* s1;                // Adam's variance
  const float* lr;          // device f32 learning rate
  const int* t;             // device int32 update count (Adam)
  long long u, c, n;
  float lr_mult, wd, rescale, clip, mu, b1, b2, omb1, omb2, eps;
};

template <int ROUTE>
__global__ void __launch_bounds__(kThreads)
    rsp_lazy_update_kernel(const __grid_constant__ LazyArgs p) {
  const float lr = __fmul_rn(*p.lr, p.lr_mult);
  float a = 0.f;
  if (ROUTE == 2) {
    // O1's class form: lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t), all f32
    const float tf = static_cast<float>(*p.t);
    const float c2 = __fsub_rn(1.f, powf(p.b2, tf));
    const float c1 = __fsub_rn(1.f, powf(p.b1, tf));
    a = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(c2)), c1);
  }
  const long long total = p.u * p.c;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const long long r = e / p.c;
    const long long row = p.idx[r];
    if (row < 0 || row >= p.n) continue;
    const long long j = row * p.c + (e - r * p.c);
    float w = p.w[j];
    float g = __fmul_rn(p.g[e], p.rescale);
    if (p.clip >= 0.f) g = clip(g, p.clip);
    if (ROUTE == 0) {
      w = __fmaf_rn(-lr, __fmaf_rn(p.wd, w, g), w);
    } else if (ROUTE == 1) {
      const float gd = __fmaf_rn(p.wd, w, g);
      const float nm = __fmaf_rn(-lr, gd, __fmul_rn(p.mu, p.s0[j]));
      w = __fadd_rn(w, nm);
      p.s0[j] = nm;
    } else if (ROUTE == 2) {
      g = __fadd_rn(g, __fmul_rn(p.wd, w));
      const float m =
          __fadd_rn(__fmul_rn(p.b1, p.s0[j]), __fmul_rn(p.omb1, g));
      const float v = __fadd_rn(__fmul_rn(p.b2, p.s1[j]),
                                __fmul_rn(p.omb2, __fmul_rn(g, g)));
      const float den = __fadd_rn(__fsqrt_rn(v), p.eps);
      // O1's w - eta*(a*m/den + d*w) with d = 0 and eta = 1: the 0*w and
      // 1*upd terms stay, so an inf weight gives NaN as O1 gives it
      const float upd =
          __fadd_rn(__fdiv_rn(__fmul_rn(a, m), den), __fmul_rn(0.f, w));
      w = __fsub_rn(w, __fmul_rn(1.f, upd));
      p.s0[j] = m;
      p.s1[j] = v;
    } else {
      g = __fadd_rn(g, __fmul_rn(p.wd, w));
      const float hist = __fadd_rn(p.s0[j], __fmul_rn(g, g));
      w = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, g),
                                 __fsqrt_rn(__fadd_rn(hist, p.eps))));
      p.s0[j] = hist;
    }
    p.w[j] = w;
  }
}

}  // namespace

// O7.  data (nnz,) f32, indptr (m + 1,) and cols (nnz,) int64, rhs and
// out f32 row-major with kdim columns.  transpose_a: out (n, kdim), rhs
// m rows; out is zeroed (cudaMemsetAsync) before the kernel adds into
// it.  Else out (m, kdim), rhs n rows.  One kernel launch, none when m
// is 0.
extern "C" int mxtt_csr_dot(const void* data, const void* indptr,
                            const void* cols, const void* rhs, void* out,
                            long long m, long long n, long long kdim,
                            long long nnz, int transpose_a, void* stream,
                            int* launched) {
  *launched = 0;
  if (m < 0 || n < 0 || kdim <= 0 || nnz < 0) return kBadArgs;
  CsrArgs p;
  p.data = static_cast<const float*>(data);
  p.indptr = static_cast<const long long*>(indptr);
  p.cols = static_cast<const long long*>(cols);
  p.rhs = static_cast<const float*>(rhs);
  p.out = static_cast<float*>(out);
  p.m = m;
  p.n = n;
  p.kdim = kdim;
  p.vec4 = kdim % 4 == 0 && reinterpret_cast<uintptr_t>(rhs) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!transpose_a) {
    if (m == 0) return 0;
    if (kdim == 1) {
      // lanes a row: the least power of two that takes a mean row in one
      // pass of four nonzeros a lane
      const long long mean = (nnz + m - 1) / m;
      int lanes = 1;
      while (lanes < 32 && 4LL * lanes < mean) lanes <<= 1;
      const long long blocks = (m * lanes + kThreads - 1) / kThreads;
      if (blocks > 0x7fffffffLL) return kBadArgs;
      const unsigned g = static_cast<unsigned>(blocks);
      switch (lanes) {
        case 1: csr_dot_k1_kernel<1><<<g, kThreads, 0, s>>>(p); break;
        case 2: csr_dot_k1_kernel<2><<<g, kThreads, 0, s>>>(p); break;
        case 4: csr_dot_k1_kernel<4><<<g, kThreads, 0, s>>>(p); break;
        case 8: csr_dot_k1_kernel<8><<<g, kThreads, 0, s>>>(p); break;
        case 16: csr_dot_k1_kernel<16><<<g, kThreads, 0, s>>>(p); break;
        default: csr_dot_k1_kernel<32><<<g, kThreads, 0, s>>>(p); break;
      }
    } else {
      const long long blocks = (m + kWarps - 1) / kWarps;
      if (blocks > 0x7fffffffLL) return kBadArgs;
      const unsigned g = static_cast<unsigned>(blocks);
      if (p.vec4)
        csr_dot_rows_kernel<true><<<g, kThreads, 0, s>>>(p);
      else
        csr_dot_rows_kernel<false><<<g, kThreads, 0, s>>>(p);
    }
    ++*launched;
    return static_cast<int>(cudaGetLastError());
  }
  if (n == 0) return 0;
  if (n >= static_cast<long long>(kEmpty)) return kBadArgs;  // 32-bit keys
  const cudaError_t e = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n * kdim) * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (m == 0) return 0;
  const long long tiles = (m + 31) / 32;
  if (tiles > 0x7fffffffLL) return kBadArgs;
  const unsigned g = static_cast<unsigned>(tiles);
  if (kdim == 1)
    csr_dot_t_kernel<0><<<g, kThreads, 0, s>>>(p);
  else if (p.vec4)
    csr_dot_t_kernel<2><<<g, kThreads, 0, s>>>(p);
  else
    csr_dot_t_kernel<1><<<g, kThreads, 0, s>>>(p);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

// O8.  route 0 SGD, 1 SGD with momentum (s0), 2 Adam (s0 mean, s1
// variance), 3 AdaGrad (s0 history); lr f32 and t int32 device scalars.
extern "C" int mxtt_rsp_lazy_update(
    int route, void* w, const void* g, const void* idx, void* s0, void* s1,
    const void* lr, const void* t, long long u, long long c, long long n,
    float lr_mult, float wd, float rescale, float clip_at, float mu,
    float b1, float b2, float omb1, float omb2, float eps, void* stream,
    int* launched) {
  *launched = 0;
  if (u <= 0 || c <= 0) return 0;
  if (route < 0 || route > 3 || lr == nullptr ||
      (route == 2 && t == nullptr) || (route >= 1 && s0 == nullptr) ||
      (route == 2 && s1 == nullptr))
    return kBadArgs;
  LazyArgs p;
  p.w = static_cast<float*>(w);
  p.g = static_cast<const float*>(g);
  p.idx = static_cast<const long long*>(idx);
  p.s0 = static_cast<float*>(s0);
  p.s1 = static_cast<float*>(s1);
  p.lr = static_cast<const float*>(lr);
  p.t = static_cast<const int*>(t);
  p.u = u;
  p.c = c;
  p.n = n;
  p.lr_mult = lr_mult;
  p.wd = wd;
  p.rescale = rescale;
  p.clip = clip_at;
  p.mu = mu;
  p.b1 = b1;
  p.b2 = b2;
  p.omb1 = omb1;
  p.omb2 = omb2;
  p.eps = eps;
  const long long blocks = (u * c + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0: rsp_lazy_update_kernel<0><<<grid, kThreads, 0, s>>>(p); break;
    case 1: rsp_lazy_update_kernel<1><<<grid, kThreads, 0, s>>>(p); break;
    case 2: rsp_lazy_update_kernel<2><<<grid, kThreads, 0, s>>>(p); break;
    default: rsp_lazy_update_kernel<3><<<grid, kThreads, 0, s>>>(p); break;
  }
  ++*launched;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_sparse_error_string(int err) {
  if (err == kBadArgs) return "bad arguments (route, sizes or states)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
