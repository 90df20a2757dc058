// Greedy non-maximum suppression for Hopper (sm_90a): O4 box_nms.
//
// No Pallas kernel stands behind this.  The JAX package's _box_nms
// (mxnet_tpu/ops/contrib.py:85-112) sorts each image's boxes by score,
// builds the full (N, N) IoU matrix and runs the greedy loop as one
// lax.fori_loop over the N sorted boxes:
//
//   keep = valid0;  for i: keep &= ~(keep[i] & (iou[i] > t) & (j > i))
//
// _contrib_box_nms and, through it, _contrib_MultiBoxDetection reach it.
// This file computes exactly that keep mask, from the boxes already
// sorted (corner format, f32) and valid0 (score > valid_thresh).
//
// Design.
// - Pass 1 (nms_mask_kernel), parallel: block (cb, rb, b) takes 64 rows
//   and 64 columns of image b and writes, for each row i, one 64-bit word
//   whose bit k says iou(i, cb*64 + k) > t for a column after i.  Tiles
//   below the diagonal are skipped and never read.  No (N, N) float
//   matrix is formed: the words take N * ceil(N/64) * 8 bytes an image.
// - Pass 2 (nms_scan_kernel), one block an image: the greedy walk, one
//   64-box word at a time.  The block loads the word's 64 diagonal
//   words and valid flags into shared memory, thread 0 walks its 64 boxes in order
//   (a kept box suppresses the later boxes of the same word at once),
//   and then every thread ORs the kept rows' words into the later words
//   of the suppressed set, one word a thread.  The keep mask is the
//   greedy result bit for bit, since each box is decided after every
//   earlier box.
// - The IoU is rounded as torch's
//   inter / max(area_l + area_r - inter, 1e-12) rounds it, op by op in
//   that order, through the _rn intrinsics (which nvcc never contracts
//   into FMAs), with NaN propagated as torch.maximum/minimum and
//   clamp_min(0) propagate it.  So a pair at the threshold is decided as
//   the plain version decides it.
//
// Each entry point returns cudaGetLastError() (or kBad* for arguments it
// refuses), launches on the caller's stream and writes the number of
// kernels it launched to *launched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // boxes a word
constexpr int kScanThreads = 128;
constexpr int kMaxWords = 4096;       // 32 KB of suppressed words: N <= 262,144
constexpr int kBadSize = -1;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float area(float4 q) {
  return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
}

// torch's iou(l, r), op for op (see the file comment)
__device__ __forceinline__ float iou(float4 l, float al, float4 r, float ar) {
  float w = __fsub_rn(nan_min(l.z, r.z), nan_max(l.x, r.x));
  float h = __fsub_rn(nan_min(l.w, r.w), nan_max(l.y, r.y));
  w = w < 0.f ? 0.f : w;              // clamp_min(0): NaN stays NaN
  h = h < 0.f ? 0.f : h;
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(al, ar), inter);
  return __fdiv_rn(inter, nan_max(uni, 1e-12f));
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int words, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ float4 col[kTile];
  __shared__ float col_area[kTile];
  const float4* img = boxes + (long long)b * n;
  const int c0 = cb * kTile;
  const int tid = threadIdx.x;
  if (c0 + tid < n) {
    const float4 q = img[c0 + tid];
    col[tid] = q;
    col_area[tid] = area(q);
  }
  __syncthreads();
  const int row = rb * kTile + tid;
  if (row >= n) return;
  const float4 r = img[row];
  const float ar = area(r);
  const int cols = min(kTile, n - c0);
  const int first = (cb == rb) ? tid + 1 : 0;
  unsigned long long bits = 0ull;
  for (int k = first; k < cols; ++k) {
    if (iou(r, ar, col[k], col_area[k]) > thresh) bits |= 1ull << k;
  }
  mask[((long long)b * n + row) * words + cb] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];   // [words]
  __shared__ unsigned long long diag[kTile];
  __shared__ uint8_t diag_valid[kTile];
  __shared__ unsigned long long kept_word;
  const int b = blockIdx.x, tid = threadIdx.x;
  const unsigned long long* m = mask + (long long)b * n * words;
  const uint8_t* v = valid + (long long)b * n;
  uint8_t* out = keep + (long long)b * n;
  for (int w = tid; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  for (int w = 0; w < words; ++w) {
    const int base = w * kTile;
    const int cnt = min(kTile, n - base);
    if (tid < cnt) {
      diag[tid] = m[(long long)(base + tid) * words + w];
      diag_valid[tid] = v[base + tid];
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long sup = removed[w], kept = 0ull;
      for (int k = 0; k < cnt; ++k) {
        if (diag_valid[k] && !((sup >> k) & 1ull)) {
          kept |= 1ull << k;
          sup |= diag[k];
        }
      }
      kept_word = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_word;
    if (tid < cnt) out[base + tid] = (uint8_t)((kept >> tid) & 1ull);
    for (int w2 = w + 1 + tid; w2 < words; w2 += blockDim.x) {
      unsigned long long acc = removed[w2];
      for (unsigned long long rest = kept; rest; rest &= rest - 1) {
        const int k = __ffsll((long long)rest) - 1;
        acc |= m[(long long)(base + k) * words + w2];
      }
      removed[w2] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mxtt_nms_words(int n) { return (n + kTile - 1) / kTile; }

extern "C" int mxtt_nms_max_boxes() { return kMaxWords * kTile; }

// boxes: (batch, n, 4) f32 corner boxes, sorted; valid: (batch, n) bytes;
// mask: (batch, n, words) u64 workspace; keep: (batch, n) bytes out.
extern "C" int mxtt_box_nms(const void* boxes, const void* valid, int batch,
                            int n, float thresh, void* mask, void* keep,
                            void* stream, int* launched) {
  *launched = 0;
  const int words = mxtt_nms_words(n);
  if (batch <= 0 || n <= 0) return 0;
  if (words > kMaxWords || batch > 65535) return kBadSize;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const float4*>(boxes), n, words, thresh,
      static_cast<unsigned long long*>(mask));
  ++*launched;
  const size_t smem = sizeof(unsigned long long) * words;
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, words,
      static_cast<uint8_t*>(keep));
  ++*launched;
  return (int)cudaGetLastError();
}

extern "C" const char* mxtt_nms_error_string(int err) {
  if (err == kBadSize) return "too many boxes or images for one launch";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
