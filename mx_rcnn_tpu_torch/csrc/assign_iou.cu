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
// Two kernels, one launch each per batch:
//   * assign_gtmax: grid (ceil(N / 2048), B).  Each block holds its image's
//     gt in shared memory, each thread 8 anchors in registers; per gt the
//     block reduces its anchors' IoU (warp shuffles, then across warps) and
//     writes one per-tile partial maximum: partials (B, tiles, G).
//   * assign_rows: grid (ceil(N / 1024), B).  Each block first reduces its
//     image's partials to gt_max (block x == 0 also writes it out), then
//     each thread takes 4 anchors and writes max_overlap, argmax and the
//     tie predicate from its own IoU values.
// No atomics: every reduction is a max, so its result does not depend on
// the order, and the partials route needs no float-as-int encoding.
//
// Exactness: the IoU uses the expression tree of ops/boxes.py:bbox_overlaps
// with explicitly rounded operations (__fadd_rn etc.; the build passes
// -fmad=false) and a true division, so every IoU equals the plain version's
// elementwise PyTorch ops bit for bit, and so do the four outputs.
//
// What bounds it on this card: each kernel computes an IoU (16 f32
// operations) for every pair of anchor and VALID gt (assign_gtmax: inside
// anchors only), against ~16·N + 10·B·N bytes of anchors, flags and
// outputs (argmax counted as the int32 the function needs; the kernel
// writes int64 for torch's gather).  With all G = 100 gt valid (B=2, N=21 888) the pair does ~140
// MFLOP, ~2 us at 67 TFLOP/s, and operations bound it; with the few gt of
// a typical image bytes do, at well under a microsecond.  Either way the
// work is of the order of a launch; this simple design is latency-bound
// instead: a block walks its image's gt one after another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGt = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGtmaxPerThread = 8;
constexpr int kGtmaxTile = kThreads * kGtmaxPerThread;  // 2048 anchors
constexpr int kRowsPerThread = 4;
constexpr int kRowsTile = kThreads * kRowsPerThread;    // 1024 anchors
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// bbox_overlaps(anchor, gt): anchor area `aa` first in the union, as the
// plain version's `area_b + area_q - inter`.
__device__ __forceinline__ float iou(float ax1, float ay1, float ax2,
                                     float ay2, float aa, float gx1,
                                     float gy1, float gx2, float gy2,
                                     float ga) {
  float iw = __fadd_rn(__fsub_rn(fminf(ax2, gx2), fmaxf(ax1, gx1)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(ay2, gy2), fmaxf(ay1, gy1)), 1.0f);
  iw = fmaxf(iw, 0.0f);
  ih = fmaxf(ih, 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(aa, ga), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-14f));
}

struct GtSmem {
  float x1[kMaxGt], y1[kMaxGt], x2[kMaxGt], y2[kMaxGt], area[kMaxGt];
  unsigned char valid[kMaxGt];
};

__device__ __forceinline__ void load_gt(GtSmem& s, const float* gt,
                                        const unsigned char* gt_valid,
                                        int g_count) {
  for (int g = threadIdx.x; g < g_count; g += blockDim.x) {
    const float* p = gt + (size_t)g * 4;
    s.x1[g] = p[0];
    s.y1[g] = p[1];
    s.x2[g] = p[2];
    s.y2[g] = p[3];
    s.area[g] = box_area(p[0], p[1], p[2], p[3]);
    s.valid[g] = gt_valid[g];
  }
}

__global__ void __launch_bounds__(kThreads)
assign_gtmax_kernel(const float* __restrict__ anchors,
                    const float* __restrict__ gt,
                    const unsigned char* __restrict__ gt_valid,
                    const unsigned char* __restrict__ inside, int n,
                    int g_count, int tiles, float* __restrict__ partials) {
  __shared__ GtSmem s;
  __shared__ float warp_max[kWarps][kMaxGt];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  load_gt(s, gt + (size_t)b * g_count * 4, gt_valid + (size_t)b * g_count,
          g_count);

  float ax1[kGtmaxPerThread], ay1[kGtmaxPerThread], ax2[kGtmaxPerThread],
      ay2[kGtmaxPerThread], aa[kGtmaxPerThread];
  bool in[kGtmaxPerThread];
  const unsigned char* ins = inside + (size_t)b * n;
#pragma unroll
  for (int k = 0; k < kGtmaxPerThread; ++k) {
    const int i = tile * kGtmaxTile + k * kThreads + threadIdx.x;
    in[k] = i < n && ins[i];
    if (in[k]) {
      const float* p = anchors + (size_t)i * 4;
      ax1[k] = p[0];
      ay1[k] = p[1];
      ax2[k] = p[2];
      ay2[k] = p[3];
      aa[k] = box_area(p[0], p[1], p[2], p[3]);
    } else {
      ax1[k] = ay1[k] = ax2[k] = ay2[k] = aa[k] = 0.0f;
    }
  }
  __syncthreads();

  for (int g = 0; g < g_count; ++g) {
    float m = -1.0f;
    if (s.valid[g]) {
#pragma unroll
      for (int k = 0; k < kGtmaxPerThread; ++k)
        if (in[k])
          m = fmaxf(m, iou(ax1[k], ay1[k], ax2[k], ay2[k], aa[k], s.x1[g],
                           s.y1[g], s.x2[g], s.y2[g], s.area[g]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFullWarp, m, off));
    if (lane == 0) warp_max[warp][g] = m;
  }
  __syncthreads();
  float* out = partials + ((size_t)b * tiles + tile) * g_count;
  for (int g = threadIdx.x; g < g_count; g += kThreads) {
    float m = warp_max[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w][g]);
    out[g] = m;
  }
}

__global__ void __launch_bounds__(kThreads)
assign_rows_kernel(const float* __restrict__ anchors,
                   const float* __restrict__ gt,
                   const unsigned char* __restrict__ gt_valid,
                   const unsigned char* __restrict__ inside,
                   const float* __restrict__ partials, int n, int g_count,
                   int tiles, float* __restrict__ max_overlap,
                   long long* __restrict__ argmax, float* __restrict__ gt_max,
                   unsigned char* __restrict__ tie) {
  __shared__ GtSmem s;
  __shared__ float s_gtmax[kMaxGt];
  const int b = blockIdx.y;
  load_gt(s, gt + (size_t)b * g_count * 4, gt_valid + (size_t)b * g_count,
          g_count);
  const float* part = partials + (size_t)b * tiles * g_count;
  for (int g = threadIdx.x; g < g_count; g += kThreads) {
    float m = -1.0f;
    for (int t = 0; t < tiles; ++t)
      m = fmaxf(m, part[(size_t)t * g_count + g]);
    s_gtmax[g] = m;
    if (blockIdx.x == 0) gt_max[(size_t)b * g_count + g] = m;
  }
  __syncthreads();

  const unsigned char* ins = inside + (size_t)b * n;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = blockIdx.x * kRowsTile + k * kThreads + threadIdx.x;
    if (i >= n) break;
    const float* p = anchors + (size_t)i * 4;
    const float ax1 = p[0], ay1 = p[1], ax2 = p[2], ay2 = p[3];
    const float aa = box_area(ax1, ay1, ax2, ay2);
    const bool in = ins[i] != 0;
    float best = 0.0f;
    int best_g = 0;
    bool t = false;
    for (int g = 0; g < g_count; ++g) {
      float v = -1.0f;
      if (s.valid[g]) {
        v = iou(ax1, ay1, ax2, ay2, aa, s.x1[g], s.y1[g], s.x2[g], s.y2[g],
                s.area[g]);
        const float gm = s_gtmax[g];
        t |= in && gm > 0.0f && v == gm;
      }
      if (g == 0 || v > best) {  // strict: ties keep the lowest g
        best = v;
        best_g = g;
      }
    }
    const size_t o = (size_t)b * n + i;
    max_overlap[o] = best;
    argmax[o] = best_g;
    tie[o] = t;
  }
}

}  // namespace

extern "C" {

// anchors (N, 4), gt (B, G, 4) float32, gt_valid (B, G) / inside (B, N)
// bool -> partials (B, ceil(N / 2048), G) float32: per-tile maxima of the
// IoU over inside anchors (-1 where a tile has none, or the gt is invalid).
int mxr_assign_gtmax(const float* anchors, const float* gt,
                     const unsigned char* gt_valid,
                     const unsigned char* inside, int batch, int n,
                     int g_count, float* partials, void* stream) {
  const int tiles = (n + kGtmaxTile - 1) / kGtmaxTile;
  const dim3 grid(tiles, batch);
  assign_gtmax_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      anchors, gt, gt_valid, inside, n, g_count, tiles, partials);
  return (int)cudaGetLastError();
}

// ... + partials -> max_overlap (B, N) float32, argmax (B, N) int64,
// gt_max (B, G) float32, tie (B, N) bool.
int mxr_assign_rows(const float* anchors, const float* gt,
                    const unsigned char* gt_valid, const unsigned char* inside,
                    const float* partials, int batch, int n, int g_count,
                    float* max_overlap, long long* argmax, float* gt_max,
                    unsigned char* tie, void* stream) {
  const int tiles = (n + kGtmaxTile - 1) / kGtmaxTile;
  const dim3 grid((n + kRowsTile - 1) / kRowsTile, batch);
  assign_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      anchors, gt, gt_valid, inside, partials, n, g_count, tiles, max_overlap,
      argmax, gt_max, tie);
  return (int)cudaGetLastError();
}

}  // extern "C"
