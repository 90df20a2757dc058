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
// Bound.  The walk needs one IoU for each kept box against each later
// box, nothing else: at the SSD decode's 32 x 7,220 boxes about 42 M
// IoUs, about 9 us at the f32 peak.  The walk is sequential in the boxes,
// so the time goes to the latency of its chain.
//
// Two routes: the cluster route for images of up to kClusterMaxWords * 64
// boxes, the two-pass route above that.
//
// The cluster route (nms_cluster_kernel), one launch.
// - C = 8 CTAs an image (the portable cluster size; fewer for an image of
//   fewer than 8 words), launched as one thread-block cluster:
//   they run together and pass the walk between them through distributed
//   shared memory.  CTA r holds the 64-box words r, r + C, r + 2C, ...
//   in its shared memory: boxes, areas, valid bits and removed bits, and
//   for each word its diagonal tile (for each row, the 64-bit word of the
//   later boxes of its own word that it would suppress) and its window
//   tile (the same for each row of the word before, against this word).
// - The walk, word x by the walker warp of CTA x % C: it ORs into x's
//   removed bits the window tile's rows of word x - 1's kept boxes, walks
//   x's 64 boxes (a kept box clears the bits its diagonal word names) and
//   sends x's kept bits, 8 bytes, to every CTA of the cluster (a store and
//   a released flag each).  That is the chain: one hop between CTAs a
//   word (about 0.45 us on an idle H100, tools/torch_dsmem_latency.py),
//   a few bit operations and the walk itself; no IoU.
// - Everything else waits off the chain.  The other seven warps of each
//   CTA take each word t's kept bits as they arrive, read those rows from
//   the input and apply them to the CTA's words from t + 2 on, one warp a
//   32-column half-word, testing only the columns still alive (valid, not
//   removed); the walker waits for them to be past word x - 2.  Between
//   words they compute the tiles of the CTA's next words, two turns of
//   the cluster ahead of the walker.
// - So the IoUs computed are the walk's own plus two tiles a word, not
//   the N^2 / 2 of every pair, and nothing goes through device memory but
//   the boxes in and the keep flags out.  32 images x 8 CTAs fill the
//   card.
//
// The two-pass route (nms_mask_kernel, then nms_scan_kernel).
// - Pass 1, parallel: block (cb, rb, b) takes 64 rows and 64 columns of
//   image b and writes, for each row i, one 64-bit word whose bit k says
//   iou(i, cb*64 + k) > t for a column after i.  Tiles below the diagonal
//   are skipped.  The words take N * ceil(N/64) * 8 bytes an image.
// - Pass 2, one block an image: the greedy walk, one 64-box word at a
//   time.  The block loads the word's 64 diagonal words and valid flags
//   into shared memory, thread 0 walks its 64 boxes in order, and then
//   every thread ORs the kept rows' words into the later words of the
//   suppressed set, one word a thread.
//
// On both routes each box is decided after every earlier box, so the keep
// mask is the greedy result bit for bit.  The IoU is rounded as torch's
// inter / max(area_l + area_r - inter, 1e-12) rounds it, op by op in that
// order, through the _rn intrinsics (which nvcc never contracts into
// FMAs), with NaN propagated as torch.maximum/minimum and clamp_min(0)
// propagate it.  So a pair at the threshold is decided as the plain
// version decides it.  Where the threshold is >= 0 and finite, the
// cluster route decides a pair without the divide: a pair apart on an
// axis or whose intersection is 0 is not above it, and otherwise the
// rounded quotient is compared by an exact product in double (see
// Thresh).  A threshold below 0 (or NaN), and a NaN or infinite
// intersection or denominator, take the divide.
//
// Each entry point returns cudaGetLastError() (or kBad* for arguments it
// refuses), launches on the caller's stream, allocates nothing and writes
// the number of kernels it launched to *launched.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;             // boxes a word
constexpr int kScanThreads = 128;
constexpr int kMaxWords = 4096;       // 32 KB of suppressed words: N <= 262,144
constexpr int kBadSize = -1;
constexpr int kClusterCtas = 8;       // CTAs an image (portable)
constexpr int kClusterThreads = 256;
constexpr int kWarps = kClusterThreads / 32;
constexpr int kAppliers = kWarps - 1;   // warp 0 walks
constexpr int kClusterMaxWords = 256; // the cluster route: N <= 16,384
constexpr int kWin = 1;               // words the walker applies by tile
constexpr int kChunks = (1 + kWin) * 2;  // 32-row tile chunks a word

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float area_of(float4 q) {
  return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
}

// The threshold as the IoU test takes it.  With fast (a finite
// threshold >= 0), a pair with inter == 0 is not above it (its quotient
// would be 0 or NaN), and for a finite inter and denominator the rounded
// quotient is compared without the divide: RN(inter / den) > t exactly
// when inter > mid * den, or inter == mid * den and the tie rounds up
// (RN(mid) is the float after t), where mid is the midpoint of t and the
// float after it.  mid * den is exact in double (25 + 24 significant
// bits).
struct Thresh {
  float t;
  bool fast;
  bool tie_up;
  double mid;
};

__host__ __device__ inline Thresh make_thresh(float t, bool fast) {
  Thresh th;
  th.t = t;
  th.fast = fast && t >= 0.f && t < 3.4028234663852886e38f;
  const float next = nextafterf(t, 3.4028234663852886e38f);
  th.mid = th.fast ? 0.5 * ((double)t + (double)next) : 0.0;
  uint32_t bits;
  memcpy(&bits, &next, sizeof(bits));
  th.tie_up = (bits & 1u) == 0u;
  return th;
}

// torch's iou(l, r) > thresh, op for op (see the file comment).  Where
// both areas are finite, so are all eight corners: min and max then need
// no NaN care, and a pair with w or h <= 0 (inter 0) is not above a fast
// threshold.
__device__ __forceinline__ bool iou_above(float4 l, float al, float4 r,
                                          float ar, const Thresh& th) {
  if (th.fast && isfinite(al) && isfinite(ar)) {
    const float w = __fsub_rn(fminf(l.z, r.z), fmaxf(l.x, r.x));
    const float h = __fsub_rn(fminf(l.w, r.w), fmaxf(l.y, r.y));
    if (!(w > 0.f) || !(h > 0.f)) return false;
    const float inter = __fmul_rn(w, h);
    const float den = fmaxf(__fsub_rn(__fadd_rn(al, ar), inter), 1e-12f);
    if (isfinite(inter) && isfinite(den)) {
      const double a = (double)inter, p = th.mid * (double)den;
      return a > p || (a == p && th.tie_up);
    }
    return __fdiv_rn(inter, den) > th.t;
  }
  float w = __fsub_rn(nan_min(l.z, r.z), nan_max(l.x, r.x));
  float h = __fsub_rn(nan_min(l.w, r.w), nan_max(l.y, r.y));
  w = w < 0.f ? 0.f : w;              // clamp_min(0): NaN stays NaN
  h = h < 0.f ? 0.f : h;
  const float inter = __fmul_rn(w, h);
  if (th.fast && inter == 0.f) return false;
  const float den = nan_max(__fsub_rn(__fadd_rn(al, ar), inter), 1e-12f);
  if (th.fast && isfinite(inter) && isfinite(den)) {
    const double a = (double)inter, p = th.mid * (double)den;
    return a > p || (a == p && th.tie_up);
  }
  return __fdiv_rn(inter, den) > th.t;
}

// -- the two-pass route ------------------------------------------------------

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int words, Thresh th,
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
    col_area[tid] = area_of(q);
  }
  __syncthreads();
  const int row = rb * kTile + tid;
  if (row >= n) return;
  const float4 r = img[row];
  const float ar = area_of(r);
  const int cols = min(kTile, n - c0);
  const int first = (cb == rb) ? tid + 1 : 0;
  unsigned long long bits = 0ull;
  for (int k = first; k < cols; ++k) {
    if (iou_above(r, ar, col[k], col_area[k], th))
      bits |= 1ull << k;
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

// -- the cluster route -------------------------------------------------------

// The kept rows of one word, compacted.
struct Stage {
  float4 box[kTile];
  float area[kTile];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of p's counterpart in CTA cta of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(p)), "r"(cta));
  return remote;
}

// Word x's kept bits into kw[x] of CTA cta, then its flag have[x] = 1,
// released to the cluster.
__device__ __forceinline__ void send_kept(unsigned long long* kw, int* have,
                                          int x, int cta,
                                          unsigned long long kept) {
  asm volatile("st.shared::cluster.u64 [%0], %1;\n"
               :: "r"(cluster_addr(&kw[x], cta)), "l"(kept) : "memory");
  asm volatile("st.release.cluster.shared::cluster.u32 [%0], %1;\n"
               :: "r"(cluster_addr(&have[x], cta)), "r"(1) : "memory");
}

// wait for have[x] in this CTA, acquiring what its sender wrote before
__device__ __forceinline__ void wait_have(const int* have, int x) {
  int got;
  do {
    asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];\n"
                 : "=r"(got) : "r"(smem_addr(&have[x])) : "memory");
  } while (got == 0);
}

// the smallest of n volatile counters
__device__ __forceinline__ int lowest(const volatile int* c, int n) {
  int low = c[0];
  for (int a = 1; a < n; ++a) low = min(low, c[a]);
  return low;
}

// Whether a row of st (its m rows, taken four at a time so that their
// IoUs overlap) suppresses the column (q, aq).
__device__ __forceinline__ bool stage_suppresses(const Stage* st, int m,
                                                 float4 q, float aq,
                                                 const Thresh& th) {
  bool sup = false;
  for (int r = 0; r < m && !sup; r += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = min(r + u, m - 1);
      sup |= iou_above(st->box[i], st->area[i], q, aq, th);
    }
  }
  return sup;
}

// Set the removed bits that a row of the stage st (its m rows) gives the
// half-words hw of [hw0, hw1) with hw % step == owner (32 columns each,
// one warp); only columns still alive (valid, not removed) are tested.
__device__ __forceinline__ void apply_stage(
    const Stage* st, int m, int hw0, int hw1, int step, int owner,
    const float4* box, const float* area, const unsigned* valid_bits,
    unsigned* removed, const Thresh& th, int lane) {
  if (m == 0) return;
  for (int hw = hw0 + ((owner - hw0) % step + step) % step; hw < hw1;
       hw += step) {
    const unsigned alive = valid_bits[hw] & ~removed[hw];
    if (alive == 0u) continue;            // the same for the whole warp
    const int i = hw * 32 + lane;
    const bool sup = ((alive >> lane) & 1u)
                     && stage_suppresses(st, m, box[i], area[i], th);
    const unsigned bits = __ballot_sync(0xffffffffu, sup);
    if (lane == 0 && bits) removed[hw] |= bits;
  }
}

// Tile chunk c of this CTA's tile rows (kChunks a word: the diagonal
// tile's 64 rows, then each window tile's): 32 rows of one tile of local
// word c / kChunks.  Lane l loads row l; the warp takes the 32 rows in
// turn, four at a time, and each row's 64-bit word comes from two
// ballots (column j is lane j's or lane j - 32's).  A diagonal row is
// left 0 where the box is not valid, and so is a window row of a word
// before the first.
__device__ __forceinline__ void tile_chunk(
    int c, int C, int rank, const float4* box, const float* area,
    const unsigned* valid_bits, unsigned long long* diag,
    unsigned long long* win, const float4* img, const Thresh& th,
    int lane) {
  const int lw = c / kChunks, d = (c % kChunks) * 32 / kTile;
  const int i0 = (c * 32) % kTile, x = lw * C + rank;
  float4 rb = make_float4(0.f, 0.f, 0.f, 0.f);
  float ra = 0.f;
  bool has;
  if (d == 0) {
    rb = box[lw * kTile + i0 + lane];
    ra = area[lw * kTile + i0 + lane];
    has = (valid_bits[(lw * kTile + i0) / 32] >> lane) & 1u;
  } else {
    has = x - d >= 0;
    if (has) {
      rb = img[(long long)(x - d) * kTile + i0 + lane];
      ra = area_of(rb);
    }
  }
  const float4 c0 = box[lw * kTile + lane];
  const float4 c1 = box[lw * kTile + lane + 32];
  const float a0 = area[lw * kTile + lane];
  const float a1 = area[lw * kTile + lane + 32];
  unsigned long long* out = d == 0 ? diag + lw * kTile
                                   : win + (lw * kWin + d - 1) * kTile;
  for (int u0 = 0; u0 < 32; u0 += 4) {
    bool lo[4], hi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int src = u0 + u, i = i0 + src;
      const float4 r = make_float4(__shfl_sync(0xffffffffu, rb.x, src),
                                   __shfl_sync(0xffffffffu, rb.y, src),
                                   __shfl_sync(0xffffffffu, rb.z, src),
                                   __shfl_sync(0xffffffffu, rb.w, src));
      const float ar = __shfl_sync(0xffffffffu, ra, src);
      const bool h = __shfl_sync(0xffffffffu, has, src);
      lo[u] = h && (d > 0 || lane > i) && iou_above(r, ar, c0, a0, th);
      hi[u] = h && (d > 0 || lane + 32 > i) && iou_above(r, ar, c1, a1, th);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned blo = __ballot_sync(0xffffffffu, lo[u]);
      const unsigned bhi = __ballot_sync(0xffffffffu, hi[u]);
      if (lane == 0) out[i0 + u0 + u] = ((unsigned long long)bhi << 32) | blo;
    }
  }
}

// One cluster of C CTAs an image (see the file comment).  CTA r holds the
// image's words r, r + C, r + 2C, ...: local word lw is word x = lw*C + r.
// Dynamic shared memory, L local words: boxes [L*64] float4, the
// diagonal tiles [L*64] u64, the window tiles [L*kWin*64] u64, areas
// [L*64] f32, removed and valid bits [2L] u32 each (a half-word: 32
// columns) and the kept words [L] u64.  Window tile d of word x holds,
// for each row i of word x - d, the columns of x that it suppresses.
//
// Warp 0 walks the CTA's words in turn.  For word x it ORs into x's
// removed bits the window tiles' rows of the kept boxes of words x - 1 ..
// x - kWin (kw[], as their owners send them), waits for the appliers to
// be past stage x - kWin - 1, walks x, and sends x's kept bits to every
// CTA.  Warps 1 .. 7 apply each word t's kept rows, in order, to the
// CTA's words from t + kWin + 1 on, one warp a half-word (hw % 7), the
// rows read from the input; each reports the last word it has applied.
__global__ void __launch_bounds__(kClusterThreads)
nms_cluster_kernel(const float4* __restrict__ boxes,
                   const uint8_t* __restrict__ valid, int n, int words,
                   int local_words, float thresh,
                   uint8_t* __restrict__ keep) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int L = local_words;
  const int nl = words > rank ? (words - rank + C - 1) / C : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  unsigned long long* diag =
      reinterpret_cast<unsigned long long*>(box + L * kTile);
  unsigned long long* win = diag + L * kTile;
  float* area = reinterpret_cast<float*>(win + L * kWin * kTile);
  unsigned* removed = reinterpret_cast<unsigned*>(area + L * kTile);
  unsigned* valid_bits = removed + 2 * L;
  unsigned long long* kept_words =
      reinterpret_cast<unsigned long long*>(valid_bits + 2 * L);
  __shared__ unsigned long long kw[kClusterMaxWords];  // kept bits of x
  __shared__ int have[kClusterMaxWords];               // kw[x] arrived
  __shared__ __align__(16) Stage stage[kAppliers];
  __shared__ int progress[kAppliers];  // the last word each applier did
  __shared__ int tiles_done[kClusterMaxWords];   // chunks of a local word
  const float4* img = boxes + (long long)b * n;
  const uint8_t* v = valid + (long long)b * n;
  const Thresh th = make_thresh(thresh, true);

  for (int x = tid; x < words; x += kClusterThreads) have[x] = 0;
  for (int lw = tid; lw < L; lw += kClusterThreads) tiles_done[lw] = 0;
  if (tid < kAppliers) progress[tid] = -1;
  for (int i = tid; i < L * kTile; i += kClusterThreads) {
    const long long j = (long long)((i / kTile) * C + rank) * kTile
                        + (i % kTile);
    const bool in = j < n;
    const float4 q = in ? img[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    box[i] = q;
    area[i] = area_of(q);
    const unsigned bits = __ballot_sync(0xffffffffu, in && v[in ? j : 0]);
    if (lane == 0) {
      valid_bits[i / 32] = bits;
      removed[i / 32] = 0u;
    }
  }
  __syncthreads();

  // the first word's tiles now, by every warp; the others' by the
  // appliers, ahead of the walker
  for (int c = warp; c < kChunks && nl > 0; c += kWarps)
    tile_chunk(c, C, rank, box, area, valid_bits, diag, win, img, th, lane);
  cluster.sync();   // every CTA runs, its flags clear, before any DSMEM use

  if (warp == 0) {
    for (int lw = 0; lw < nl; ++lw) {
      const int x = lw * C + rank;
      if (lw > 0) {
        const volatile int* done = tiles_done;
        while (done[lw] < kChunks) {}
        __threadfence_block();
      }
      unsigned long long near = 0ull;     // the window's removed bits
      for (int d = 1; d <= kWin && d <= x; ++d) {
        wait_have(have, x - d);
        const unsigned long long k = kw[x - d];
        const unsigned long long* t = win + (lw * kWin + d - 1) * kTile;
        if ((k >> lane) & 1ull) near |= t[lane];
        if ((k >> (lane + 32)) & 1ull) near |= t[lane + 32];
      }
      near = ((unsigned long long)__reduce_or_sync(0xffffffffu,
                                                   (unsigned)(near >> 32))
              << 32)
             | __reduce_or_sync(0xffffffffu, (unsigned)near);
      while (lowest(progress, kAppliers) < x - kWin - 1) {}
      __threadfence_block();
      unsigned long long kept = 0ull;
      if (lane == 0) {
        const unsigned long long vb =
            ((unsigned long long)valid_bits[2 * lw + 1] << 32)
            | valid_bits[2 * lw];
        const unsigned long long rb =
            ((unsigned long long)removed[2 * lw + 1] << 32)
            | removed[2 * lw];
        unsigned long long alive = vb & ~rb & ~near;
        while (alive) {
          const int k = __ffsll((long long)alive) - 1;
          kept |= 1ull << k;
          alive &= ~diag[lw * kTile + k];
          alive &= alive - 1ull;          // bit k itself
        }
        kept_words[lw] = kept;
      }
      kept = __shfl_sync(0xffffffffu, kept, 0);
      if (x + 1 < words && lane < C) send_kept(kw, have, x, lane, kept);
    }
  } else {
    const int a = warp - 1;
    Stage* st = &stage[a];
    int tiled = 1;                        // the next local word to tile
    for (int t = 0; t + 1 < words; ++t) {
      // the tiles of the words up to two rounds of the cluster ahead
      for (; tiled < nl && tiled * C + rank <= t + 2 * C; ++tiled) {
        for (int j = a; j < kChunks; j += kAppliers)
          tile_chunk(tiled * kChunks + j, C, rank, box, area, valid_bits,
                     diag, win, img, th, lane);
        __syncwarp();
        if (lane == 0 && a < kChunks) {
          __threadfence_block();
          atomicAdd(&tiles_done[tiled], (kChunks - a + kAppliers - 1)
                                        / kAppliers);
        }
      }
      // the first of this CTA's words at t + kWin + 1 or later
      const int far = t + kWin + 1;
      const int lw0 = far > rank ? (far - rank + C - 1) / C : 0;
      if (lw0 < nl) {
        wait_have(have, t);
        const unsigned long long k = kw[t];
        if (k) {
          for (int h = 0; h < 2; ++h) {
            const int bit = lane + 32 * h;
            if ((k >> bit) & 1ull) {
              const int pos = __popcll(k & ((1ull << bit) - 1ull));
              const float4 q = img[(long long)t * kTile + bit];
              st->box[pos] = q;
              st->area[pos] = area_of(q);
            }
          }
          __syncwarp();
          apply_stage(st, __popcll(k), 2 * lw0, 2 * nl, kAppliers, a, box,
                      area, valid_bits, removed, th, lane);
        }
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *(volatile int*)&progress[a] = t;
      }
    }
  }
  __syncthreads();

  uint8_t* out = keep + (long long)b * n;
  for (int i = tid; i < nl * kTile; i += kClusterThreads) {
    const long long j = (long long)((i / kTile) * C + rank) * kTile
                        + (i % kTile);
    if (j < n)
      out[j] = (uint8_t)((kept_words[i / kTile] >> (i % kTile)) & 1ull);
  }
  cluster.sync();   // no CTA leaves while another may still write to it
}

// The cluster route's CTAs an image for n boxes (kClusterCtas, or the
// largest power of two up to the number of words), its local words and
// its dynamic shared memory.
int cluster_shape(int n, int* local_words, size_t* smem) {
  const int words = (n + kTile - 1) / kTile;
  int c = 1;
  while (2 * c <= kClusterCtas && 2 * c <= words) c *= 2;
  *local_words = (words + c - 1) / c;
  *smem = (size_t)*local_words * kTile * (sizeof(float4)
                                          + (1 + kWin)
                                            * sizeof(unsigned long long)
                                          + sizeof(float))
          + (size_t)*local_words * (4 * sizeof(unsigned)
                                    + sizeof(unsigned long long));
  return c;
}

}  // namespace

extern "C" int mxtt_nms_words(int n) { return (n + kTile - 1) / kTile; }

extern "C" int mxtt_nms_max_boxes() { return kMaxWords * kTile; }

extern "C" int mxtt_nms_cluster_max_boxes() {
  return kClusterMaxWords * kTile;
}

// The cluster route.  boxes: (batch, n, 4) f32 corner boxes, sorted;
// valid: (batch, n) bytes; keep: (batch, n) bytes out.
extern "C" int mxtt_nms_cluster(const void* boxes, const void* valid,
                                int batch, int n, float thresh, void* keep,
                                void* stream, int* launched) {
  *launched = 0;
  if (batch <= 0 || n <= 0) return 0;
  if (mxtt_nms_words(n) > kClusterMaxWords) return kBadSize;
  int L = 0;
  size_t smem = 0;
  const int c = cluster_shape(n, &L, &smem);
  if ((long long)batch * c > 0x7fffffffLL) return kBadSize;
  cudaError_t e = cudaFuncSetAttribute(
      nms_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * c));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_cluster_kernel,
                         static_cast<const float4*>(boxes),
                         static_cast<const uint8_t*>(valid), n,
                         mxtt_nms_words(n), L, thresh,
                         static_cast<uint8_t*>(keep));
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return (int)cudaGetLastError();
}

// The two passes as entry points of their own, so each can be timed
// alone.  boxes: (batch, n, 4) f32 corner boxes, sorted; valid: (batch, n)
// bytes; mask: (batch, n, words) u64 workspace; keep: (batch, n) bytes out.
extern "C" int mxtt_nms_mask_pass(const void* boxes, int batch, int n,
                                  float thresh, void* mask, void* stream,
                                  int* launched) {
  *launched = 0;
  const int words = mxtt_nms_words(n);
  if (batch <= 0 || n <= 0) return 0;
  if (words > kMaxWords || batch > 65535) return kBadSize;
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), n, words, make_thresh(thresh, false),
      static_cast<unsigned long long*>(mask));
  ++*launched;
  return (int)cudaGetLastError();
}

extern "C" int mxtt_nms_scan_pass(const void* mask, const void* valid,
                                  int batch, int n, void* keep, void* stream,
                                  int* launched) {
  *launched = 0;
  const int words = mxtt_nms_words(n);
  if (batch <= 0 || n <= 0) return 0;
  if (words > kMaxWords || batch > 65535) return kBadSize;
  const size_t smem = sizeof(unsigned long long) * words;
  nms_scan_kernel<<<batch, kScanThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, words,
      static_cast<uint8_t*>(keep));
  ++*launched;
  return (int)cudaGetLastError();
}

// Both passes: the two-pass route, for any n up to mxtt_nms_max_boxes().
extern "C" int mxtt_box_nms(const void* boxes, const void* valid, int batch,
                            int n, float thresh, void* mask, void* keep,
                            void* stream, int* launched) {
  int first = 0;
  int err = mxtt_nms_mask_pass(boxes, batch, n, thresh, mask, stream, &first);
  *launched = first;
  if (err != 0 || first == 0) return err;
  int second = 0;
  err = mxtt_nms_scan_pass(mask, valid, batch, n, keep, stream, &second);
  *launched += second;
  return err;
}

extern "C" const char* mxtt_nms_error_string(int err) {
  if (err == kBadSize) return "too many boxes or images for one launch";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
