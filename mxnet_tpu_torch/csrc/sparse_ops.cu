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
// O7 csr_dot, f32, indices int64 (the port's 64-bit rule):
// - out = A . rhs: one warp a row of A.  With one rhs column the lanes
//   split the row's nonzeros and reduce with shuffles; with more, each
//   lane owns columns and walks the nonzeros in order.  No atomics, so
//   two runs are bitwise equal.
// - out = A^T . rhs into a zeroed output: one warp a row of A, each
//   nonzero's product added with atomicAdd into the row its column
//   names, so the order of the sums changes from run to run.
// - Every product is rounded before it is summed (__fmul_rn, then
//   __fadd_rn or atomicAdd), as the plain version's product-then-
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

// out (m, 1) = A . rhs (n, 1): the lanes split the row's nonzeros
__global__ void __launch_bounds__(kThreads)
    csr_dot_k1_kernel(const float* __restrict__ data,
                      const long long* __restrict__ indptr,
                      const long long* __restrict__ cols,
                      const float* __restrict__ rhs, float* __restrict__ out,
                      long long m, long long n) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;                   // the whole warp leaves
  const long long lo = indptr[row], hi = indptr[row + 1];
  float acc = 0.f;
  for (long long k = lo + lane; k < hi; k += 32) {
    const long long c = cols[k];
    if (c >= 0 && c < n) acc = __fadd_rn(acc, __fmul_rn(data[k], rhs[c]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) out[row] = acc;
}

// out (m, kdim) = A . rhs (n, kdim): each lane owns columns lane + 32 j
__global__ void __launch_bounds__(kThreads)
    csr_dot_rows_kernel(const float* __restrict__ data,
                        const long long* __restrict__ indptr,
                        const long long* __restrict__ cols,
                        const float* __restrict__ rhs,
                        float* __restrict__ out, long long m, long long n,
                        long long kdim) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const long long lo = indptr[row], hi = indptr[row + 1];
  for (long long c0 = lane; c0 < kdim; c0 += 32) {
    float acc = 0.f;
    for (long long k = lo; k < hi; ++k) {
      const long long c = cols[k];
      if (c >= 0 && c < n)
        acc = __fadd_rn(acc, __fmul_rn(data[k], rhs[c * kdim + c0]));
    }
    out[row * kdim + c0] = acc;
  }
}

// out (n, 1) += A^T . rhs (m, 1): each nonzero's product into its column
__global__ void __launch_bounds__(kThreads)
    csr_dot_t_k1_kernel(const float* __restrict__ data,
                        const long long* __restrict__ indptr,
                        const long long* __restrict__ cols,
                        const float* __restrict__ rhs,
                        float* __restrict__ out, long long m, long long n) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const long long lo = indptr[row], hi = indptr[row + 1];
  const float r = rhs[row];
  for (long long k = lo + lane; k < hi; k += 32) {
    const long long c = cols[k];
    if (c >= 0 && c < n) atomicAdd(out + c, __fmul_rn(data[k], r));
  }
}

// out (n, kdim) += A^T . rhs (m, kdim)
__global__ void __launch_bounds__(kThreads)
    csr_dot_t_rows_kernel(const float* __restrict__ data,
                          const long long* __restrict__ indptr,
                          const long long* __restrict__ cols,
                          const float* __restrict__ rhs,
                          float* __restrict__ out, long long m, long long n,
                          long long kdim) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const long long lo = indptr[row], hi = indptr[row + 1];
  const float* r = rhs + row * kdim;
  for (long long k = lo; k < hi; ++k) {
    const long long c = cols[k];
    if (c < 0 || c >= n) continue;
    const float v = data[k];
    float* o = out + c * kdim;
    for (long long c0 = lane; c0 < kdim; c0 += 32)
      atomicAdd(o + c0, __fmul_rn(v, r[c0]));
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

unsigned rows_grid(long long m) {
  return static_cast<unsigned>((m + kWarps - 1) / kWarps);
}

}  // namespace

// O7.  data (nnz,) f32, indptr (m + 1,) and cols (nnz,) int64, rhs and
// out f32 row-major with kdim columns; transpose_a: out (n, kdim) must
// be zeroed by the caller, rhs has m rows; else out (m, kdim), rhs n
// rows.
extern "C" int mxtt_csr_dot(const void* data, const void* indptr,
                            const void* cols, const void* rhs, void* out,
                            long long m, long long n, long long kdim,
                            int transpose_a, void* stream, int* launched) {
  *launched = 0;
  if (m <= 0 || kdim <= 0) return 0;
  if ((m + kWarps - 1) / kWarps > 0x7fffffffLL) return kBadArgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(data);
  const long long* ip = static_cast<const long long*>(indptr);
  const long long* c = static_cast<const long long*>(cols);
  const float* r = static_cast<const float*>(rhs);
  float* o = static_cast<float*>(out);
  if (transpose_a) {
    if (kdim == 1)
      csr_dot_t_k1_kernel<<<rows_grid(m), kThreads, 0, s>>>(d, ip, c, r, o,
                                                            m, n);
    else
      csr_dot_t_rows_kernel<<<rows_grid(m), kThreads, 0, s>>>(d, ip, c, r, o,
                                                              m, n, kdim);
  } else if (kdim == 1) {
    csr_dot_k1_kernel<<<rows_grid(m), kThreads, 0, s>>>(d, ip, c, r, o, m, n);
  } else {
    csr_dot_rows_kernel<<<rows_grid(m), kThreads, 0, s>>>(d, ip, c, r, o, m,
                                                          n, kdim);
  }
  ++*launched;
  return (int)cudaGetLastError();
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
