// Fused anchor x gt IoU reductions of RPN anchor assignment, for Hopper
// (sm_90a), batched over images.
//
// Replaces mx_rcnn_tpu/kernels/assign_pallas.py:_assign_kernel.  The four
// reductions of the (N, G) IoU matrix that ops/assign_anchor.py needs are
// computed without ever writing that matrix: the IoU is recomputed from the
// (N, 4) anchors and the G <= 128 gt boxes of the image, held in shared
// memory.
//
// Contract (the plain version is kernels/assign_cuda.py:
// assign_reduce_plain, the dense path of ops/assign_anchor.py):
//   iou[i, g]     = bbox_overlaps(anchor i, gt g) if gt_valid[g] else -1
//   gt_max[g]     = max over INSIDE anchors i of iou[i, g] (-1 if none)
//   max_overlap[i] = max over g of iou[i, g]
//   argmax[i]     = the LOWEST g attaining max_overlap[i] (torch.argmax)
//   tie[i]        = any g with inside[i] & gt_valid[g] & gt_max[g] > 0 &
//                   iou[i, g] == gt_max[g]
//
// Two kernels, one launch each per batch, both on tiles of kTile = 256
// anchors, one anchor a thread, grid (ceil(N / 256), B):
//   * assign_gtmax computes every IoU once.  A block compacts its image's
//     VALID gt into shared memory in increasing index order (with each
//     one's original index) and walks only those, 32 at a time; each thread
//     keeps its anchor's running max and argmax (strict >, so ties keep
//     the lowest index) and writes max_overlap and argmax.  The per-gt
//     maxima over the tile's inside anchors come from one transposed
//     halving exchange per warp and 32 gt (31 shuffles, lane l ending
//     with gt l's maximum), then a max across the 8 warps: one per-tile
//     partial per gt, partials (B, tiles, G), -1 in invalid columns.  The
//     last block of an image to finish (a __threadfence and an integer
//     arrival counter per image, which that block resets to 0, so a CUDA
//     graph replays correctly) reduces the image's partials to gt_max.
//   * assign_rows writes the tie flag.  An anchor of tile t can tie gt g
//     only if the tile's partial equals gt_max[g] > 0 (the partial is the
//     max over the tile's inside anchors, and no partial exceeds gt_max).
//     A block keeps those candidate gt of its tile (usually none) and
//     recomputes the IoU for them alone; every other anchor gets false.
// No float atomics: every reduction is a max, so its result does not
// depend on the order; the only atomic is the integer arrival count.
//
// Exactness: the IoU uses the expression tree of ops/boxes.py:bbox_overlaps
// with explicitly rounded operations (__fadd_rn etc.; the build passes
// -fmad=false) and a true division, so every IoU equals the plain version's
// elementwise PyTorch ops bit for bit, and so do the four outputs.  One
// division is skipped, exactly.  Before its clamp iw = fl(d + 1) is never
// -0 (a rounded sum is -0 only if both terms are), and fmaxf(iw, 0) returns
// +0 for a negative iw or a NaN, so iw and ih lie in [+0, +inf] and inter =
// iw * ih is +0, positive, or NaN (+0 * inf).  The divisor fmaxf(uni,
// 1e-14f) lies in [1e-14, +inf] (fmaxf returns 1e-14 for a NaN union).  So
// when inter == 0 it is +0, the rounded quotient +0 / divisor is +0 for
// every divisor, and the kernel returns +0 without dividing; a NaN inter
// still takes the division.  The walk over valid gt only keeps argmax's
// lowest-index rule because every valid IoU is >= +0 > -1 (the value of
// every invalid column), and the compacted gt are walked in increasing
// index order; with no valid gt, max_overlap = -1 and argmax = 0, as the
// dense path gives.
//
// What bounds it on this card: the function needs one IoU (16 f32
// operations) for every pair of anchor and VALID gt, against ~17·N +
// 9·B·N bytes of anchors, flags and outputs (argmax counted as the int32
// the function needs; the kernel writes int64 for torch's gather).  With
// all G = 100 gt valid (B = 2, N = 21 888) that is 70 MFLOP, ~1 us at 67
// TFLOP/s, and operations bound it; with the few gt of a typical image
// bytes do, at well under a microsecond.  Either way the work is of the
// order of a launch, so the design aims at latency: hundreds of blocks
// even at the training batch, every independent load issued before the
// first barrier, no serial walk over padded gt, no dependent shuffle chain
// per gt, and the partials reduced once.  What is left is per warp: each
// IoU of a chunk sits in its own branch region (the zero test, and the
// correctly rounded division's check and slow-path call), so the compiler
// does not interleave the 32 IoUs of a chunk and a warp pays each one's
// dependent latency in turn; at 63 registers an SM holds 4 blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGt = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;          // anchors per block, one a thread
constexpr int kChunk = 32;               // gt per transposed exchange
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kThreads >= kMaxGt, "one thread per gt slot at load");

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// bbox_overlaps(anchor, gt): anchor area `aa` first in the union, as the
// plain version's `area_b + area_q - inter`.  The division is skipped only
// where inter == +0 (see the header).
__device__ __forceinline__ float iou(float4 a, float aa, float4 g, float ga) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)), 1.0f);
  iw = fmaxf(iw, 0.0f);
  ih = fmaxf(ih, 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f;
  const float uni = __fsub_rn(__fadd_rn(aa, ga), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-14f));
}

// Thread g (< kMaxGt) offers gt g when `keep`; returns its slot among the
// kept gt, in increasing g order, and sets *count to their number.  Every
// thread of the block must call it; it ends with a barrier.
__device__ __forceinline__ int compact(bool keep, int* warp_count,
                                       int* count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFullWarp, keep);
  if (lane == 0) warp_count[warp] = __popc(m);
  __syncthreads();
  int slot = __popc(m & ((1u << lane) - 1u)), total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) slot += warp_count[w];
    total += warp_count[w];
  }
  *count = total;
  return slot;
}

// One step of the transposed halving exchange: a lane keeps the half of
// its live slots that its W bit selects and takes the partner's copy of
// that half.  W is a template argument so that every index into v is a
// constant and v stays in registers.
template <int W>
__device__ __forceinline__ void halve(float (&v)[kChunk], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = upper ? v[j] : v[j + W];
    const float keep = upper ? v[j + W] : v[j];
    v[j] = fmaxf(keep, __shfl_xor_sync(kFullWarp, send, W));
  }
}

// v[j] holds this lane's value for gt j of a chunk of 32; afterwards v[0]
// holds the maximum over the warp's 32 lanes for gt `lane`: 16 + 8 + 4 +
// 2 + 1 shuffles.
__device__ __forceinline__ void warp_transpose_max(float (&v)[kChunk],
                                                   int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
}

__global__ void __launch_bounds__(kThreads)
assign_gtmax_kernel(const float4* __restrict__ anchors,
                    const float4* __restrict__ gt,
                    const unsigned char* __restrict__ gt_valid,
                    const unsigned char* __restrict__ inside, int n,
                    int g_count, int tiles, float* __restrict__ max_overlap,
                    long long* __restrict__ argmax,
                    float* __restrict__ gt_max, float* __restrict__ partials,
                    unsigned int* __restrict__ arrivals) {
  __shared__ float4 s_box[kMaxGt];
  __shared__ float s_area[kMaxGt];
  __shared__ int s_index[kMaxGt];
  __shared__ int s_warp_count[kWarps];
  __shared__ float s_warp_max[kWarps][kMaxGt];
  __shared__ float s_red[kThreads];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  float* part = partials + ((size_t)b * tiles + tile) * g_count;

  // every load up front, so that they overlap: thread g's gt and this
  // thread's anchor
  const int g = tid;
  const bool have_g = g < g_count;
  bool valid = false;
  float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (have_g) {
    valid = gt_valid[(size_t)b * g_count + g] != 0;
    box = gt[(size_t)b * g_count + g];
  }
  const int i = tile * kTile + tid;
  const bool have_i = i < n;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool in = false;
  if (have_i) {
    a = anchors[i];
    in = inside[(size_t)b * n + i] != 0;
  }

  // the image's valid gt, compacted in increasing index order
  int count;
  const int slot = compact(valid, s_warp_count, &count);
  if (valid) {
    s_box[slot] = box;
    s_area[slot] = box_area(box);
    s_index[slot] = g;
  } else if (have_g) {
    part[g] = -1.0f;
  }
  const float aa = box_area(a);
  float best = -1.0f;
  int best_slot = 0;
  __syncthreads();

  for (int c0 = 0; c0 < count; c0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      v[j] = -1.0f;
      if (c0 + j < count) {
        const float q = iou(a, aa, s_box[c0 + j], s_area[c0 + j]);
        if (q > best) {  // strict: ties keep the lowest gt index
          best = q;
          best_slot = c0 + j;
        }
        if (in) v[j] = q;
      }
    }
    warp_transpose_max(v, lane);
    if (c0 + lane < count) s_warp_max[warp][c0 + lane] = v[0];
  }
  if (have_i) {
    const size_t o = (size_t)b * n + i;
    max_overlap[o] = best;
    argmax[o] = count > 0 ? s_index[best_slot] : 0;
  }
  __syncthreads();
  for (int j = tid; j < count; j += kThreads) {
    float m = s_warp_max[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_warp_max[w][j]);
    part[s_index[j]] = m;
  }

  // the last block of the image to arrive reduces its partials to gt_max
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(arrivals + b, 1u) == (unsigned)tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (have_g && !valid) gt_max[(size_t)b * g_count + g] = -1.0f;
  if (count > 0) {
    // thread e takes gt slot e % count over every p-th tile, p = e / count
    const int ways = kThreads / count;
    const float* img = partials + (size_t)b * tiles * g_count;
    float m = -1.0f;
    if (tid < ways * count) {
      const int col = s_index[tid % count];
#pragma unroll 16
      for (int t = tid / count; t < tiles; t += ways)
        m = fmaxf(m, __ldcg(img + (size_t)t * g_count + col));
    }
    s_red[tid] = m;
    __syncthreads();
    if (tid < count) {
      for (int p = 1; p < ways; ++p) m = fmaxf(m, s_red[p * count + tid]);
      gt_max[(size_t)b * g_count + s_index[tid]] = m;
    }
  }
  if (tid == 0) arrivals[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
assign_rows_kernel(const float4* __restrict__ anchors,
                   const float4* __restrict__ gt,
                   const unsigned char* __restrict__ gt_valid,
                   const unsigned char* __restrict__ inside,
                   const float* __restrict__ gt_max,
                   const float* __restrict__ partials, int n, int g_count,
                   int tiles, unsigned char* __restrict__ tie) {
  __shared__ float4 s_box[kMaxGt];
  __shared__ float s_area[kMaxGt];
  __shared__ float s_gtmax[kMaxGt];
  __shared__ int s_warp_count[kWarps];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;

  // every load up front: thread g's gt, its maximum and the tile's
  // partial for it; this thread's anchor
  const int g = tid;
  bool cand = false;
  float gm = 0.0f;
  float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (g < g_count) {
    const size_t og = (size_t)b * g_count + g;
    gm = gt_max[og];
    box = gt[og];
    const bool valid = gt_valid[og] != 0;
    const float p = partials[((size_t)b * tiles + tile) * g_count + g];
    cand = valid && gm > 0.0f && p == gm;
  }
  const int i = tile * kTile + tid;
  const size_t o = (size_t)b * n + i;
  bool in = false;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < n) {
    in = inside[o] != 0;
    a = anchors[i];
  }

  // the gt whose maximum this tile attains: the only ones it can tie
  int count;
  const int slot = compact(cand, s_warp_count, &count);
  if (cand) {
    s_box[slot] = box;
    s_area[slot] = box_area(box);
    s_gtmax[slot] = gm;
  }
  __syncthreads();

  if (i >= n) return;
  bool t = false;
  if (in && count > 0) {
    const float aa = box_area(a);
    for (int j = 0; j < count; ++j)
      t |= iou(a, aa, s_box[j], s_area[j]) == s_gtmax[j];
  }
  tie[o] = t;
}

}  // namespace

extern "C" {

// anchors (N, 4), gt (B, G, 4) float32, gt_valid (B, G) / inside (B, N)
// bool -> max_overlap (B, N) float32, argmax (B, N) int64, gt_max (B, G)
// float32, partials (B, ceil(N / 256), G) float32 (per-tile maxima of the
// IoU over inside anchors; -1 where a tile has none, or the gt is invalid).
// arrivals: B uint32, zero on entry, zero again on exit.
int mxr_assign_gtmax(const float* anchors, const float* gt,
                     const unsigned char* gt_valid,
                     const unsigned char* inside, int batch, int n,
                     int g_count, float* max_overlap, long long* argmax,
                     float* gt_max, float* partials, unsigned int* arrivals,
                     void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, batch);
  assign_gtmax_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)anchors, (const float4*)gt, gt_valid, inside, n, g_count,
      tiles, max_overlap, argmax, gt_max, partials, arrivals);
  return (int)cudaGetLastError();
}

// ... + gt_max and partials of mxr_assign_gtmax -> tie (B, N) bool.
int mxr_assign_rows(const float* anchors, const float* gt,
                    const unsigned char* gt_valid, const unsigned char* inside,
                    const float* gt_max, const float* partials, int batch,
                    int n, int g_count, unsigned char* tie, void* stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, batch);
  assign_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)anchors, (const float4*)gt, gt_valid, inside, gt_max,
      partials, n, g_count, tiles, tie);
  return (int)cudaGetLastError();
}

}  // extern "C"
