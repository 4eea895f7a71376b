// Bitmask greedy NMS for Hopper (sm_90a), batched over images.
//
// Replaces mx_rcnn_tpu/kernels/nms_pallas.py:_suppress_kernel (phase A, the
// suppression bitmask) and :_sweep_kernel (phase B, the greedy sweep), with
// the algorithm of the reference's rcnn/cython/nms_kernel.cu: 64-bit words,
// boxes arriving score-sorted, plus a leading batch dimension and a sweep
// that stays on the device.
//
// Contract (the plain version is mx_rcnn_tpu_torch/ops/nms.py:nms_padded):
//   bit j of word w in row i of image b is IoU(box i, box 64w+j) > thresh,
//   for 64w+j > i only (legacy +1 areas, union clamped to >= 1e-14).  The
//   sweep keeps rows in index order (= score order), skips a row whose bit
//   is set in `removed`, ORs each kept row's words into `removed` and stops
//   after max_out kept rows.  valid == 0 rows start out removed: they are
//   never kept and, never being kept, never suppress.
//
// Exactness: the IoU uses the expression tree of ops/boxes.py:bbox_overlaps
// with explicitly rounded operations (__fadd_rn etc., and the build passes
// -fmad=false) and a true division, so every decision equals the plain
// version's elementwise PyTorch ops bit for bit.
//
// What bounds it on this card:
//   * mask kernel: n(n-1)/2 IoUs of 16 f32 operations each (per axis min,
//     max, sub, add; two clamps; the product; the union's add, sub and
//     clamp; the divide; the compare: chip_smoke.py's IOU_OPS) and a write
//     of ~n^2/16 bytes of upper-triangle words (2.3 MB at n = 6016); by
//     these counts the f32 operations, not the write, set the bound.  On
//     the card the min/max/shift pipe, at half the rate of the add/multiply
//     pipe, is the limit, so the design cuts instructions per IoU (about
//     20: 7 FMNMX, 6 FADD, 1 FMUL, 2 FFMA, 2 SHF, 2/3 LDS) and idle CTAs:
//       - only the triangle is launched: one 128-thread CTA per (image,
//         64-row block r, strip of 4 column tiles from r on), decoded from
//         the linear block index in closed form; the strip's 256 column
//         boxes are staged once in shared memory (a float4 and its area),
//         and each thread keeps two rows (t, t + 32) in registers, so one
//         pair of broadcast loads serves two IoUs;
//       - a fully unrolled 64-column loop with compile-time bit positions:
//         each decision's sign bit is shifted into a 32-bit half by one
//         funnel shift; the diagonal tile and a last, partial tile are
//         masked afterwards, never by loop bounds;
//       - no division outside a band around the threshold.  With u the
//         clamped union and t_hi, t_lo = t(1 +- 2^-20) rounded to float,
//         the signs of inter - t_hi*u and inter - t_lo*u each come from one
//         FMA (exact product, one rounding, so the sign is exact): >= 0
//         sets the bit, < 0 clears it, anything else takes the exact
//         __fdiv_rn(inter, u) > t after the loop.  Exact because rounding
//         t(1 +- 2^-20) costs at most 2^-24 relative, so outside the band
//         the real quotient lies at least 2^-21 t (four ulps) from t and
//         rounding it cannot cross t.  Allowed only for 2^-60 <= t < 1
//         (t_hi, t_lo normal; 0, 1, negative or NaN t: every IoU exact)
//         and only in a CTA whose boxes all have |coordinates| <= 2^60, so
//         that no term is inf or NaN (else that CTA is exact throughout).
//   * sweep kernel: sequential by nature, so the chain of dependent steps,
//     not bytes, bounds it.  It replaces _sweep_kernel's split (resolve an
//     8-row block in scalar registers, then OR the kept rows into
//     `removed` in one vector pass) at 64 rows, one 256-thread block per
//     image, `removed` (one word per 64 rows) in shared memory:
//       - Warp 0 resolves the 64-row blocks in order, every lane alike.  A
//         block's rows come from its tile, words w..w+7 of rows 64w..64w+63,
//         staged in shared memory two groups of four blocks ahead.  One
//         iteration per kept row: a 32-bit find-first-set, one shared load,
//         one AND (a removed row never contributes its bits); the kept
//         row's words w+1..w+7 are ORed into registers for the next seven
//         blocks (the lookahead), so the chain from block to block never
//         waits on device memory.
//       - Warps 1..7 take the kept rows of each group of four blocks and OR
//         their words past the lookahead into `removed`: thread t owns the
//         words = t (mod 224), 16 independent coalesced loads in flight, no
//         atomics; they also stage the tiles of group g+2.  Resolving group
//         g waits only on group g-2's OR pass (two named barriers per group),
//         so the OR passes' round trips overlap the resolution.
//     `removed` starts from the valid flags, 32 per ballot from one
//     coalesced load per warp.  The kernel writes keep_idx and keep_mask
//     itself, so no unpack pass follows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                   __fadd_rn(__fsub_rn(y2, y1), 1.0f));
}

// ---- the mask -----------------------------------------------------------

constexpr int kStrip = 4;                      // column tiles per CTA
constexpr int kPair = 32;                      // a thread's rows: t, t + 32
constexpr int kMaskThreads = kPair * kStrip;   // thread (rows t, t+32; tile k)

// CTAs per image: row block r has ceil((cb - r) / kStrip) strips.  With
// m = cb - r, the rows m = g*kStrip + 1 .. (g+1)*kStrip form group g, of
// g + 1 strips each, so F(M) = sum over m <= M = kStrip q(q+1)/2 + s(q+1)
// for M = q kStrip + s.
long long mask_ctas(int cb) {
  const long long q = cb / kStrip, s = cb % kStrip;
  return kStrip * q * (q + 1) / 2 + s * (q + 1);
}

// The strip of CTA k of an image: its row block r and first column tile
// c0.  CTAs run through the rows by ascending m, group by group.
__device__ __forceinline__ void mask_strip(int k, int cb, int& r, int& c0) {
  int g = (int)((sqrtf(8.0f * (float)k / kStrip + 1.0f) - 1.0f) * 0.5f);
  while (g > 0 && kStrip * g * (g + 1) / 2 > k) --g;
  while (kStrip * (g + 1) * (g + 2) / 2 <= k) ++g;
  const int kk = k - kStrip * g * (g + 1) / 2;
  r = cb - (g * kStrip + 1 + kk / (g + 1));
  c0 = r + kk % (g + 1) * kStrip;
}

// inter and the clamped union of bbox_overlaps, rounded op by op
__device__ __forceinline__ void overlap(float4 a, float aa, float4 c,
                                        float ca, float& inter, float& u) {
  const float iw = __fadd_rn(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)),
                             1.0f);
  const float ih = __fadd_rn(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)),
                             1.0f);
  inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  u = fmaxf(__fsub_rn(__fadd_rn(aa, ca), inter), 1e-14f);
}

// Every term of an IoU with such a box stays finite: |coordinates| <= 2^60
// (NaN fails the test).
__device__ __forceinline__ bool tame(float4 b) {
  return fabsf(b.x) <= 0x1p60f && fabsf(b.y) <= 0x1p60f &&
         fabsf(b.z) <= 0x1p60f && fabsf(b.w) <= 0x1p60f;
}

// One CTA per (image, 64-row block r, strip of kStrip column tiles from
// r on): thread (t, k) writes word c0 + k of rows 64r + t and 64r + t + 32.
// Warp k takes tile k, so every shared load is a broadcast, and each
// serves two IoUs.  With `fast` (2^-60 <= thresh < 1), t_hi, t_lo are
// thresh * (1 +- 2^-20).
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, int n, int cb,
                int ctas_per_image, float thresh, float t_hi, float t_lo,
                int fast, unsigned long long* __restrict__ mask) {
  const int b = blockIdx.x / ctas_per_image;
  int r, c0;
  mask_strip(blockIdx.x - b * ctas_per_image, cb, r, c0);
  const float4* img = reinterpret_cast<const float4*>(boxes) + (size_t)b * n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  __shared__ float4 col[kWord * kStrip];
  __shared__ float col_area[kWord * kStrip];
  const int tid = threadIdx.x;
  bool ok = fast;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = tid + h * kMaskThreads, cj = c0 * kWord + s;
    const float4 c = cj < n ? img[cj] : zero;
    col[s] = c;
    col_area[s] = box_area(c.x, c.y, c.z, c.w);
    ok = ok && tame(c);
  }
  const int t = tid % kPair, w = c0 + tid / kPair;
  const int i = r * kWord + t;
  float4 a[2];
  float aa[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    a[q] = i + q * kPair < n ? img[i + q * kPair] : zero;
    aa[q] = box_area(a[q].x, a[q].y, a[q].z, a[q].w);
    ok = ok && tame(a[q]);
  }
  // the fast decision for the whole CTA, or for none of it
  fast = __syncthreads_and(ok);
  if (i >= n || w >= cb) return;
  const float4* cs = col + (tid / kPair) * kWord;
  const float* cas = col_area + (tid / kPair) * kWord;

  // sign bits, column j at bit j: of inter - t_hi*u (1: not surely set)
  // and of inter - t_lo*u (1: surely clear), each from one FMA, so exact
  unsigned unset[2][2] = {{~0u, ~0u}, {~0u, ~0u}};
  unsigned clear[2][2] = {{0u, 0u}, {0u, 0u}};
  if (fast) {
#pragma unroll
    for (int j = kWord - 1; j >= 0; --j) {
      const float4 c = cs[j];
      const float ca = cas[j];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float inter, u;
        overlap(a[q], aa[q], c, ca, inter, u);
        const unsigned hi = __float_as_uint(__fmaf_rn(-t_hi, u, inter));
        const unsigned lo = __float_as_uint(__fmaf_rn(-t_lo, u, inter));
        // shift the sign bit in from the right
        unset[q][j / 32] = __funnelshift_l(hi, unset[q][j / 32], 1);
        clear[q][j / 32] = __funnelshift_l(lo, clear[q][j / 32], 1);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int tq = t + q * kPair;
    if (i + q * kPair >= n) break;
    unsigned long long keep = ~0ull;   // the columns this word may hold
    if (w == r) keep = tq == kWord - 1 ? 0ull : ~0ull << (tq + 1);
    if (n - w * kWord < kWord) keep &= (1ull << (n - w * kWord)) - 1ull;
    const unsigned long long un =
        unset[q][0] | (unsigned long long)unset[q][1] << 32;
    unsigned long long bits = ~un & keep;
    unsigned long long band =
        un & ~(clear[q][0] | (unsigned long long)clear[q][1] << 32) & keep;
    while (band) {                     // inside the band: the exact test
      const int j = __ffsll((long long)band) - 1;
      band &= band - 1ull;
      float inter, u;
      overlap(a[q], aa[q], cs[j], cas[j], inter, u);
      if (__fdiv_rn(inter, u) > thresh) bits |= 1ull << j;
    }
    mask[((size_t)b * n + i + q * kPair) * cb + w] = bits;
  }
}

// ---- the sweep ----------------------------------------------------------

constexpr int kSweepThreads = 256;
constexpr int kWorkers = kSweepThreads - 32;  // warps 1..7; warp 0 resolves
// blocks per handover from the resolver warp to the workers
constexpr int kGroup = 4;
// later words of a block's rows that the resolver ORs itself, from staged
// tiles: enough that resolving group g waits only on group g-2's OR pass
constexpr int kLook = 2 * kGroup - 1;
constexpr int kRowWords = kLook + 1;            // words v..v+kLook of a row
constexpr int kTileWords = kWord * kRowWords;   // one block's 64 rows
constexpr int kGroupWords = kGroup * kTileWords;
// kept rows loaded per burst of independent loads in the OR pass
constexpr int kBurst = 16;
// named barriers (0 is __syncthreads): group g handed over, group g's OR
// pass applied; two of each, by the parity of g
constexpr int kBarFull = 1;
constexpr int kBarDone = 3;

// shared memory: the tiles of two groups, `removed`, then per group parity
// the kept rows and their count, and the stop flag
constexpr size_t sweep_smem_bytes(int col_blocks) {
  return (size_t)(2 * kGroupWords + col_blocks) * 8 +
         (size_t)(2 * kGroup * kWord + 4) * 4;
}

__device__ __forceinline__ void copy_word_async(
    unsigned long long* dst, const unsigned long long* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for every copy this thread has started
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kSweepThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kSweepThreads)
               : "memory");
}

// Starts the copies of group g's tiles (for each of its blocks v, words
// v..v+kLook of rows 64v..64v+63, row-major: 64 contiguous bytes a row)
// into the group's slot, word t, t+stride, ... by this thread.
__device__ __forceinline__ void stage_group(const unsigned long long* m,
                                            int n, int col_blocks, int g,
                                            unsigned long long* tiles, int t,
                                            int stride) {
  unsigned long long* slot = tiles + (g & 1) * kGroupWords;
  for (int i = t; i < kGroupWords; i += stride) {
    const int v = g * kGroup + i / kTileWords;
    const int row = v * kWord + i % kTileWords / kRowWords;
    const int word = v + i % kRowWords;
    if (row < n && word < col_blocks)
      copy_word_async(slot + i, m + (size_t)row * col_blocks + word);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const unsigned char* __restrict__ valid, int n,
                 int col_blocks, int max_out, int* __restrict__ keep_idx,
                 unsigned char* __restrict__ keep_mask) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* tiles = smem;  // two groups, by parity
  unsigned long long* removed = tiles + 2 * kGroupWords;
  int* kept_rows = reinterpret_cast<int*>(removed + col_blocks);  // [2][256]
  int* kept_count = kept_rows + 2 * kGroup * kWord;               // [2]
  int* stop_flag = kept_count + 2;                                // [2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned long long* m = mask + (size_t)b * n * col_blocks;
  const unsigned char* v = valid + (size_t)b * n;
  int* out_idx = keep_idx + (size_t)b * max_out;
  unsigned char* out_ok = keep_mask + (size_t)b * max_out;

  stage_group(m, n, col_blocks, 0, tiles, tid, kSweepThreads);
  stage_group(m, n, col_blocks, 1, tiles, tid, kSweepThreads);
  // invalid rows start out removed; rows past n stay 0 and are never read
  for (int w = tid / 32; w < col_blocks; w += kSweepThreads / 32) {
    const int i = w * kWord + lane;
    const unsigned lo = __ballot_sync(kFullWarp, i < n && !v[i]);
    const unsigned hi = __ballot_sync(kFullWarp, i + 32 < n && !v[i + 32]);
    if (lane == 0) removed[w] = (unsigned long long)hi << 32 | lo;
  }
  cp_async_wait_all();
  __syncthreads();

  if (tid < 32) {
    // The resolver: every lane resolves every block from shared memory and
    // stores the same values, so all is uniform.  pend[d] holds what the
    // kept rows of the last kLook blocks remove from word w+d: the workers
    // OR only words more than kLook right of a row's block into `removed`.
    unsigned long long pend[kLook];
#pragma unroll
    for (int d = 0; d < kLook; ++d) pend[d] = 0ull;
    int cnt = 0, g = 0;
    bool stop = false;
    for (;; ++g) {
      // removed holds the ORs of every block up to group g-2's end, and the
      // workers have staged group g's tiles
      if (g >= 2) bar_sync(kBarDone + (g & 1));
      int* rows_out = kept_rows + (g & 1) * kGroup * kWord;
      int nrows = 0;
      for (int i = 0; i < kGroup && !stop; ++i) {
        const int w = g * kGroup + i;
        const unsigned long long* tile =
            tiles + (g & 1) * kGroupWords + i * kTileWords;
        const int rows = n - w * kWord;
        const unsigned long long live =
            ~(removed[w] | pend[0]) &
            (rows >= kWord ? ~0ull : (1ull << rows) - 1ull);
        unsigned long long next[kLook];
#pragma unroll
        for (int d = 0; d < kLook; ++d) next[d] = 0ull;
        // rows 0..31, then 32..63: the chain from one kept row to the next
        // is a 32-bit find-first-set, one shared load and one AND
        unsigned lo = (unsigned)live, hi = (unsigned)(live >> 32);
        while (lo && cnt < max_out) {
          const int j = __ffs(lo) - 1;
          const unsigned long long* row = tile + j * kRowWords;
          const unsigned long long diag = row[0];
          lo &= (lo - 1u) & ~(unsigned)diag;  // drop j and the rows it removes
          hi &= ~(unsigned)(diag >> 32);
#pragma unroll
          for (int d = 0; d < kLook; ++d) next[d] |= row[d + 1];
          out_idx[cnt] = rows_out[nrows] = w * kWord + j;
          out_ok[cnt] = 1;
          ++cnt;
          ++nrows;
        }
        while (hi && cnt < max_out) {
          const int j = 32 + __ffs(hi) - 1;
          const unsigned long long* row = tile + j * kRowWords;
          hi &= (hi - 1u) & ~(unsigned)(row[0] >> 32);
#pragma unroll
          for (int d = 0; d < kLook; ++d) next[d] |= row[d + 1];
          out_idx[cnt] = rows_out[nrows] = w * kWord + j;
          out_ok[cnt] = 1;
          ++cnt;
          ++nrows;
        }
#pragma unroll
        for (int d = 0; d + 1 < kLook; ++d) pend[d] = pend[d + 1] | next[d];
        pend[kLook - 1] = next[kLook - 1];
        stop = cnt >= max_out || w + 1 >= col_blocks;
      }
      kept_count[g & 1] = nrows;
      stop_flag[g & 1] = stop;
      __syncwarp();
      bar_arrive(kBarFull + (g & 1));
      if (stop) break;
    }
    if (g >= 1) bar_sync(kBarDone + ((g - 1) & 1));  // the workers' last pass
    for (int s = cnt + lane; s < max_out; s += 32) {
      out_idx[s] = 0;
      out_ok[s] = 0;
    }
  } else {
    // The workers: per group, stage the tiles of group g+2 into group g's
    // slot (the resolver is done with it), then OR the kept rows' words
    // into `removed`.  Thread t owns the words ww = t (mod 224) in every
    // pass, so no two threads ever update one word; its loads go out
    // kBurst at a time, independent and coalesced.
    const int wt = tid - 32;
    for (int g = 0;; ++g) {
      bar_sync(kBarFull + (g & 1));
      if (stop_flag[g & 1]) break;  // nothing is resolved after this group
      stage_group(m, n, col_blocks, g + 2, tiles, wt, kWorkers);
      const int nrows = kept_count[g & 1];
      const int* rows = kept_rows + (g & 1) * kGroup * kWord;
      const int first = g * kGroup + kLook + 1;
      if (nrows)
        for (int ww = first + ((wt - first) % kWorkers + kWorkers) % kWorkers;
             ww < col_blocks; ww += kWorkers) {
          const unsigned long long* col = m + ww;
          unsigned long long acc = 0ull;
          for (int t0 = 0; t0 < nrows; t0 += kBurst) {
            unsigned long long x[kBurst];
#pragma unroll
            for (int t = 0; t < kBurst; ++t) {
              const int r = t0 + t < nrows ? rows[t0 + t] : -1;
              // a row's words up to kLook right of its block are pend's
              x[t] = r >= 0 && ww > r / kWord + kLook
                         ? col[(size_t)r * col_blocks] : 0ull;
            }
#pragma unroll
            for (int t = 0; t < kBurst; ++t) acc |= x[t];
          }
          removed[ww] |= acc;
        }
      cp_async_wait_all();  // group g+2's tiles, before the handover
      bar_arrive(kBarDone + (g & 1));
    }
  }
}

}  // namespace

extern "C" {

// boxes (B, n, 4) float32 -> mask (B, n, ceil(n/64)) uint64; words left of
// each row's own 64-row block are not written.
int mxr_nms_mask(const float* boxes, int batch, int n, float thresh,
                 unsigned long long* mask, void* stream) {
  const int col_blocks = (n + kWord - 1) / kWord;
  const long long per_image = mask_ctas(col_blocks);
  if (per_image * batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the fast decision only for 2^-60 <= thresh < 1 (NaN fails), where
  // t_hi and t_lo are normal floats within 2^-24 of their real values
  const int fast = thresh >= 0x1p-60f && thresh < 1.0f;
  const float t_hi = thresh * (1.0f + 0x1p-20f);
  const float t_lo = thresh * (1.0f - 0x1p-20f);
  nms_mask_kernel<<<(unsigned)(per_image * batch), kMaskThreads, 0,
                    (cudaStream_t)stream>>>(boxes, n, col_blocks,
                                            (int)per_image, thresh, t_hi,
                                            t_lo, fast, mask);
  return (int)cudaGetLastError();
}

// mask (B, n, ceil(n/64)) uint64, valid (B, n) bool -> keep_idx (B, max_out)
// int32 in score order (padded slots 0), keep_mask (B, max_out) bool.
int mxr_nms_sweep(const unsigned long long* mask, const unsigned char* valid,
                  int batch, int n, int max_out, int* keep_idx,
                  unsigned char* keep_mask, void* stream) {
  const int col_blocks = (n + kWord - 1) / kWord;
  const size_t smem = sweep_smem_bytes(col_blocks);
  if (smem > 48 * 1024) {  // past the default: opt in (227 KB on Hopper)
    const cudaError_t e = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_sweep_kernel<<<batch, kSweepThreads, smem, (cudaStream_t)stream>>>(
      mask, valid, n, col_blocks, max_out, keep_idx, keep_mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
