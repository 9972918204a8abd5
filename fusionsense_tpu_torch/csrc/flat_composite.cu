// Flat segmented pair compositing on Hopper: kernels K1 (forward) and K2
// (backward) of the flat rasterizer backend.
//
// Replaces: fusionsense_tpu/render/pallas_flat.py, functions _fwd_kernel (K1)
// and _bwd_kernel (K2), with the alpha math of
// fusionsense_tpu/render/pallas_composite2.py::_alpha_of_chunk.
//
// What bounds it on the H100: operations. Every composited (pair, pixel)
// costs two transcendentals (exp, log1p) and ~40 FP32 operations forward,
// ~90 backward, while the table, the per-block state and the outputs are
// tens of MB. The Pallas grid walks each tile's run of 128-pair blocks in
// order, carrying log T (backward: the suffix S) from block to block. Runs
// are very uneven (at the bench's shapes one tile owns ~158 blocks, the
// mean is ~4), so one CTA per tile leaves the card idle behind the longest
// run. Here no CTA composites more than one block.
//
// Design. A block entered at per-pixel log T `L` adds exp(L) * acc_b to the
// output and delta_b to log T, where acc_b = sum_j alpha_j exp(cum_j - lg_j)
// chan_j and delta_b = sum_j lg_j (lg = log1p(-alpha), cum its inclusive
// prefix) are the block's own, taken from T = 1: neither depends on L. So
// K1 is three launches and K2 two:
//  1. fwd_blocks: one CTA per block, one thread per pixel, writes delta_b
//     (nb, P), acc_b (nb, C, P) and the number of rows it staged (nb,),
//     B less the rows culled; zeros for blocks with count 0. The hot run's
//     blocks run on as many CTAs as it has blocks.
//  2. fwd_scan: one CTA per tile walks its run in order with the reference's
//     skip rule: carry[b] = L; the block is live iff count > 0 and some
//     pixel has L > -9.21 (__syncthreads_or, never per pixel, so saturated
//     pixels keep accumulating until the whole tile is); if live,
//     L += delta_b. These are the reference's carries, frozen once the tile
//     saturates; log T is the final L. Per block this is one 4 KB read, one
//     barrier (none for a block with count 0, such as the dummy tile's) and
//     one 4 KB write; the reads go out kBatch blocks at a time.
//  3. fwd_combine: one CTA per (tile, channel) sums exp(carry_b) * acc_b
//     over the run's live blocks, in order.
//  4. bwd_suffix: one thread per (tile, pixel) walks the run in reverse:
//     S_b = sum of A_b' over the later live blocks, with A_b = exp(carry_b)
//     * sum_c g_c acc_b[c] = sum_j w_j q_j of block b, so the suffix that
//     the reference carries from block to block needs no alpha.
//  5. bwd_blocks: one CTA per live block runs block_backward
//     (composite_common.cuh) from its own S_b and its exit log T (the next
//     block's carry, or the tile's final log T); dead blocks write zeros.
// Each output row belongs to one CTA and every sum is taken in a fixed
// order: no atomics, and the result is deterministic. Every row of out /
// logT, every carry, live flag, S and dtab row is written: tiles without
// blocks get out = 0 and log T = 0.
//
// Row cull, in the staging of passes 1 and 5. A row whose values are all
// finite, with log_op <= -15 and a positive-semidefinite conic (ca >= 0,
// cc >= 0, ca * cc >= cb^2), has power = log_op - Q(dx, dy) with Q >= 0, so
// alpha_raw <= exp(-15) < 1/255: alpha = 0 and alive = false at every
// pixel. In float32 the PSD test and Q itself round, so Q may come out
// slightly negative; both errors are a few ulps of E = ca X^2 / 2 +
// |cb| X Y + cc Y^2 / 2, where X and Y bound |dx| and |dy| over the tile's
// pixels, and E <= 1e5 keeps them below 0.1, far inside the margin from -15
// to log(1/255) = -5.5. Such a row adds exactly zero to acc_b and delta_b
// (log1p(-0) = 0), and backward to S and to every dtab column (d_power = 0
// where !alive; w = 0 * T_excl), given a finite T_excl and finite
// cotangents: the backward culls only when every pixel's exit log T and
// cotangents are finite (a uniform vote), so a NaN from upstream reaches
// dtab as in the reference. A row with a non-finite value is never culled,
// so a poisoned parameter still reaches the step guard. The dead slots of
// the render prefix (opacity 0, log_op = log(1e-12)) are such rows. The
// kept rows are staged in order (leaving out exact zeros changes no sum),
// and culled rows get zero dtab rows. chip_smoke.py holds fwd_blocks'
// count of kept rows against the plain test, and times both block passes
// again with the cull defeated: the difference is what the cull saves.
//
// Plain C entry points (bound with ctypes) launch on the caller's stream
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using fs::kGroup;
using fs::kTEpsLog;

constexpr float kCullLogOp = -15.0f;
constexpr float kCullQuadMax = 1e5f;
constexpr float kInertLogOp = -1e10f;   // the table's own padding value
constexpr int kBatch = 8;               // blocks a run walker loads at once
constexpr int kSuffixThreads = 128;

// The tile that owns block b: the largest t < num_tiles with runs[t] <= b.
__device__ __forceinline__ int tile_of(const int* runs, int num_tiles, int b) {
  int lo = 0, hi = num_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (runs[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The cull test above, for one row r of a block of `tile`.
template <int W>
__device__ __forceinline__ bool culled(const float (&r)[W], int tile,
                                       int tiles_x, int tile_size) {
  bool finite = true;
#pragma unroll
  for (int k = 0; k < W; ++k) finite = finite && isfinite(r[k]);
  const float ca = r[2], cb = r[3], cc = r[4];
  if (!(finite && r[5] <= kCullLogOp && ca >= 0.0f && cc >= 0.0f &&
        ca * cc >= cb * cb))
    return false;
  const float x0 = (float)((tile % tiles_x) * tile_size) + 0.5f;
  const float y0 = (float)((tile / tiles_x) * tile_size) + 0.5f;
  const float span = (float)(tile_size - 1);
  const float X = fmaxf(fabsf(x0 - r[0]), fabsf(x0 + span - r[0]));
  const float Y = fmaxf(fabsf(y0 - r[1]), fabsf(y0 + span - r[1]));
  return 0.5f * ca * X * X + fabsf(cb) * X * Y + 0.5f * cc * Y * Y <=
         kCullQuadMax;
}

// Stages the B rows of one block at src into s_tab, in order, leaving out
// the culled ones when `cull` is set. s_pos[j] is row j's staged position,
// or -1; s_warp holds 32 ints of scratch. Returns the number of rows staged,
// the same in every thread; ends on a barrier.
template <int W>
__device__ int stage_kept(float* s_tab, int* s_pos, int* s_warp,
                          const float* src, int B, bool cull, int tile,
                          int tiles_x, int tile_size) {
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  int n = 0;
  for (int base = 0; base < B; base += P) {
    const int j = base + p;
    float r[W];
    bool keep = false;
    if (j < B) {
#pragma unroll
      for (int k = 0; k < W; ++k) r[k] = src[j * W + k];
      keep = !(cull && culled<W>(r, tile, tiles_x, tile_size));
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int off = n, total = n;
    for (int w = 0; w < (P >> 5); ++w) {
      const int c = s_warp[w];
      off += (w < warp) ? c : 0;
      total += c;
    }
    if (j < B) {
      const int pos = keep ? off + __popc(m & ((1u << lane) - 1u)) : -1;
      s_pos[j] = pos;
      if (keep) {
#pragma unroll
        for (int k = 0; k < W; ++k) s_tab[pos * W + k] = r[k];
      }
    }
    n = total;
    __syncthreads();   // s_warp is reused, s_tab / s_pos are read next
  }
  return n;
}

template <int C>
__global__ void fwd_blocks_kernel(const float* __restrict__ table,
                                  const int* __restrict__ runs,
                                  const int* __restrict__ blk_count,
                                  float* __restrict__ delta,
                                  float* __restrict__ acc_out,
                                  int* __restrict__ kept, int num_tiles,
                                  int tiles_x, int tile_size, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float smem[];
  float* s_tab = smem;                                       // B * W
  int* s_pos = reinterpret_cast<int*>(s_tab + B * W);        // B
  int* s_warp = s_pos + B;                                   // 32
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  float log_t = 0.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int n = 0;
  if (blk_count[b] > 0) {   // uniform over the CTA
    const int t = tile_of(runs, num_tiles, b);
    n = stage_kept<W>(s_tab, s_pos, s_warp, table + (size_t)b * B * W, B,
                      true, t, tiles_x, tile_size);
    fs::composite_block<C>(s_tab, n, fs::pixel_of(t, tiles_x, tile_size, p),
                           log_t, acc);
  }
  if (p == 0) kept[b] = n;
  delta[(size_t)b * P + p] = log_t;
#pragma unroll
  for (int c = 0; c < C; ++c) acc_out[((size_t)b * C + c) * P + p] = acc[c];
}

__global__ void fwd_scan_kernel(const float* __restrict__ delta,
                                const int* __restrict__ runs,
                                const int* __restrict__ blk_count,
                                float* __restrict__ carry,
                                int* __restrict__ live,
                                float* __restrict__ logt) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int b_end = runs[t + 1];
  float L = 0.0f;
  for (int base = runs[t]; base < b_end; base += kBatch) {
    float d[kBatch];
    int n[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const bool in = base + k < b_end;
      d[k] = in ? delta[(size_t)(base + k) * P + p] : 0.0f;
      n[k] = in ? blk_count[base + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int b = base + k;
      if (b >= b_end) break;   // uniform over the CTA
      carry[(size_t)b * P + p] = L;
      // the vote only where it can matter: n[k] is uniform over the CTA
      const bool lv = n[k] > 0 && __syncthreads_or(L > kTEpsLog);
      if (p == 0) live[b] = lv ? 1 : 0;
      if (lv) L += d[k];
    }
  }
  logt[(size_t)t * P + p] = L;
}

__global__ void fwd_combine_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ carry,
                                   const int* __restrict__ live,
                                   const int* __restrict__ runs,
                                   float* __restrict__ out, int C) {
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int b_end = runs[t + 1];
  float o = 0.0f;
  for (int base = runs[t]; base < b_end; base += kBatch) {
    float e[kBatch], a[kBatch];
    bool use[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {   // dead blocks cost no reads
      const int b = base + k;
      use[k] = b < b_end && live[b] != 0;
      e[k] = use[k] ? carry[(size_t)b * P + p] : 0.0f;
      a[k] = use[k] ? acc[((size_t)b * C + c) * P + p] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (use[k]) o += expf(e[k]) * a[k];
  }
  out[((size_t)t * C + c) * P + p] = o;
}

template <int C>
__global__ void bwd_suffix_kernel(const float* __restrict__ acc,
                                  const float* __restrict__ carry,
                                  const int* __restrict__ live,
                                  const int* __restrict__ runs,
                                  const float* __restrict__ g_out,
                                  float* __restrict__ S, int num_tiles,
                                  int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_tiles * P) return;
  const int t = i / P;
  const int p = i % P;
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_out[((size_t)t * C + c) * P + p];
  const int b_begin = runs[t];
  float s = 0.0f;
  for (int top = runs[t + 1] - 1; top >= b_begin; top -= kBatch) {
    float e[kBatch], q[kBatch];
    bool use[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {   // dead blocks cost no reads
      const int b = top - k;
      use[k] = b >= b_begin && live[b] != 0;
      e[k] = use[k] ? carry[(size_t)b * P + p] : 0.0f;
      q[k] = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        q[k] += use[k] ? g[c] * acc[((size_t)b * C + c) * P + p] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int b = top - k;
      if (b < b_begin) break;
      S[(size_t)b * P + p] = s;
      if (use[k]) s += expf(e[k]) * q[k];
    }
  }
}

template <int C>
__global__ void bwd_blocks_kernel(const float* __restrict__ table,
                                  const int* __restrict__ runs,
                                  const int* __restrict__ live,
                                  const float* __restrict__ g_out,
                                  const float* __restrict__ g_logt,
                                  const float* __restrict__ logt,
                                  const float* __restrict__ carry,
                                  const float* __restrict__ S,
                                  float* __restrict__ dtab, int num_tiles,
                                  int tiles_x, int tile_size, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float smem[];
  const int P = blockDim.x;
  float* s_tab = smem;                          // B * W
  float* s_out = s_tab + B * W;                 // B * W
  float* s_part = s_out + B * W;                // fs::reduce_floats(P, C)
  int* s_pos = reinterpret_cast<int*>(s_part + fs::reduce_floats(P, C));
  int* s_warp = s_pos + B;                      // 32
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  float* dst = dtab + (size_t)b * B * W;
  if (live[b] == 0) {   // uniform over the CTA
    for (int i = p; i < B * W; i += P) dst[i] = 0.0f;
    return;
  }
  const int t = tile_of(runs, num_tiles, b);
  float g[C];
  bool finite = true;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    g[c] = g_out[((size_t)t * C + c) * P + p];
    finite = finite && isfinite(g[c]);
  }
  const float glt = g_logt[(size_t)t * P + p];
  const float logt_fin = logt[(size_t)t * P + p];
  // exit log T of this block: the next block's carry, or the final log T
  const float L =
      (b + 1 < runs[t + 1]) ? carry[(size_t)(b + 1) * P + p] : logt_fin;
  const bool cull = __syncthreads_and(finite && isfinite(L));
  const int n = stage_kept<W>(s_tab, s_pos, s_warp, table + (size_t)b * B * W,
                              B, cull, t, tiles_x, tile_size);
  // block_backward walks groups of kGroup rows: pad with inert rows
  const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
  for (int i = n * W + p; i < n_pad * W; i += P)
    s_tab[i] = (i % W == 5) ? kInertLogOp : 0.0f;
  __syncthreads();
  fs::block_backward<C>(s_tab, s_part, s_out, n_pad,
                        fs::pixel_of(t, tiles_x, tile_size, p), g, glt,
                        expf(logt_fin), L, S[(size_t)b * P + p]);
  for (int i = p; i < B * W; i += P) {
    const int pos = s_pos[i / W];
    dst[i] = (pos >= 0) ? s_out[pos * W + i % W] : 0.0f;
  }
}

size_t fwd_blocks_smem(int B, int C) {
  return (size_t)B * (8 + C) * sizeof(float) + ((size_t)B + 32) * sizeof(int);
}

size_t bwd_blocks_smem(int P, int B, int C) {
  return (2 * (size_t)B * (8 + C) + (size_t)fs::reduce_floats(P, C)) *
             sizeof(float) +
         ((size_t)B + 32) * sizeof(int);
}

}  // namespace

// num_tiles counts the dummy tile: runs has num_tiles + 1 entries.

extern "C" int fs_flat_fwd_blocks(const float* table, const int* runs,
                                  const int* blk_count, float* delta,
                                  float* acc, int* kept, int num_blocks,
                                  int num_tiles, int tiles_x, int tile_size,
                                  int B, int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  if (num_blocks == 0) return 0;
  fwd_blocks_kernel<8><<<num_blocks, tile_size * tile_size,
                         fwd_blocks_smem(B, C), (cudaStream_t)stream>>>(
      table, runs, blk_count, delta, acc, kept, num_tiles, tiles_x, tile_size,
      B);
  return (int)cudaGetLastError();
}

extern "C" int fs_flat_fwd_scan(const float* delta, const int* runs,
                                const int* blk_count, float* carry, int* live,
                                float* logt, int num_tiles, int P,
                                void* stream) {
  fwd_scan_kernel<<<num_tiles, P, 0, (cudaStream_t)stream>>>(
      delta, runs, blk_count, carry, live, logt);
  return (int)cudaGetLastError();
}

extern "C" int fs_flat_fwd_combine(const float* acc, const float* carry,
                                   const int* live, const int* runs,
                                   float* out, int num_tiles, int P, int C,
                                   void* stream) {
  fwd_combine_kernel<<<dim3(num_tiles, C), P, 0, (cudaStream_t)stream>>>(
      acc, carry, live, runs, out, C);
  return (int)cudaGetLastError();
}

extern "C" int fs_flat_bwd_suffix(const float* acc, const float* carry,
                                  const int* live, const int* runs,
                                  const float* g_out, float* S, int num_tiles,
                                  int P, int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  const int n = num_tiles * P;
  bwd_suffix_kernel<8><<<(n + kSuffixThreads - 1) / kSuffixThreads,
                         kSuffixThreads, 0, (cudaStream_t)stream>>>(
      acc, carry, live, runs, g_out, S, num_tiles, P);
  return (int)cudaGetLastError();
}

extern "C" int fs_flat_bwd_blocks(const float* table, const int* runs,
                                  const int* live, const float* g_out,
                                  const float* g_logt, const float* logt,
                                  const float* carry, const float* S,
                                  float* dtab, int num_blocks, int num_tiles,
                                  int tiles_x, int tile_size, int B, int C,
                                  void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  if (num_blocks == 0) return 0;
  const int P = tile_size * tile_size;
  const size_t smem = bwd_blocks_smem(P, B, C);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_blocks_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_blocks_kernel<8><<<num_blocks, P, smem, (cudaStream_t)stream>>>(
      table, runs, live, g_out, g_logt, logt, carry, S, dtab, num_tiles,
      tiles_x, tile_size, B);
  return (int)cudaGetLastError();
}
