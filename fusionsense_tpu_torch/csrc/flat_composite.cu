// Flat segmented pair compositing on Hopper: kernels K1 (forward) and K2
// (backward) of the flat rasterizer backend.
//
// Replaces: fusionsense_tpu/render/pallas_flat.py, functions _fwd_kernel (K1)
// and _bwd_kernel (K2), with the alpha math of
// fusionsense_tpu/render/pallas_composite2.py::_alpha_of_chunk.
//
// What bounds it on the H100: operations. Every live (pair, pixel) costs two
// transcendentals (exp, log1p) and ~30 FP32 operations forward, ~70 backward,
// while the table, outputs and carries are a few tens of MB; the backward
// also reduces 14 sums per pair over the tile's pixels. In practice, at the
// bench's shapes, the time is set by the longest tile run, which one CTA
// walks serially while the other SMs idle (PERF.md); splitting long runs
// across CTAs is left to a later change.
//
// Design:
// - The Pallas grid runs in order on one core and carries per-tile log T
//   (forward) and the suffix S (backward) in VMEM across grid steps. CUDA
//   blocks run in no order, so here ONE CTA owns ONE tile and walks that
//   tile's contiguous run of 128-pair blocks itself (forward in K1, reverse
//   in K2); run boundaries come from the wrapper (a searchsorted of
//   blk_tile). One thread per pixel keeps log T or S in a register.
// - Each block's table rows (B x (8+C) floats, 8 KB) are staged in shared
//   memory; every thread reads the same row at a time (a broadcast).
// - The block-level skip of the reference is kept: a block is skipped only
//   when every pixel of the tile is saturated (__syncthreads_or), never per
//   pixel, so saturated pixels keep accumulating exactly as in JAX.
// - The MXU prefix matmul becomes a sequential walk over the block's pairs
//   in each thread. K2 recovers T_excl in reverse order in log space from
//   the block's exit log T (the next block's carry, or the tile's final
//   log T) by subtracting log1p(-alpha) as it walks back.
// - The per-pair sums over pixels are CTA reductions (warp shuffles, then a
//   shared-memory pass over the warps for 16 pairs at a time); a warp whose
//   pixels all have alpha = 0 for a pair skips its shuffles, since all of
//   its contributions are exactly zero. Each pair row belongs to one tile,
//   so no global atomics are needed.
// - Every row of out / logT, every carry and every dtab row is written:
//   tiles without blocks get out = 0 and log T = 0, dead blocks zero rows.
// - The alpha math and the forward and backward walks over one staged block
//   live in composite_common.cuh, shared with K3/K4 (composite2.cu).
//
// Plain C entry points (bound with ctypes) launch on the caller's stream
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using fs::kTEpsLog;
using fs::Pixel;

template <int C>
__global__ void flat_fwd_kernel(const float* __restrict__ table,
                                const int* __restrict__ runs,
                                const int* __restrict__ blk_count,
                                float* __restrict__ out,
                                float* __restrict__ logt_out,
                                float* __restrict__ carry, int tiles_x,
                                int tile_size, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float s_tab[];  // B * W
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int b_begin = runs[t];
  const int b_end = runs[t + 1];
  const Pixel px = fs::pixel_of(t, tiles_x, tile_size, p);

  float log_t = 0.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int b = b_begin; b < b_end; ++b) {
    carry[(size_t)b * P + p] = log_t;
    // barrier too: nobody still reads the previous block's rows
    const int open = __syncthreads_or(log_t > kTEpsLog);
    if (blk_count[b] <= 0 || !open) continue;   // uniform over the CTA
    fs::stage_rows(s_tab, table + (size_t)b * B * W, B * W, p, P);
    __syncthreads();
    fs::composite_block<C>(s_tab, B, px, log_t, acc);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[((size_t)t * C + c) * P + p] = acc[c];
  logt_out[(size_t)t * P + p] = log_t;
}

template <int C>
__global__ void flat_bwd_kernel(const float* __restrict__ table,
                                const int* __restrict__ runs,
                                const int* __restrict__ blk_count,
                                const float* __restrict__ g_out,
                                const float* __restrict__ g_logt,
                                const float* __restrict__ logt,
                                const float* __restrict__ carry,
                                float* __restrict__ dtab, int tiles_x,
                                int tile_size, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float smem[];
  float* s_tab = smem;                 // B * W
  float* s_part = smem + B * W;        // fs::reduce_floats(P, C)
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int b_begin = runs[t];
  const int b_end = runs[t + 1];
  const Pixel px = fs::pixel_of(t, tiles_x, tile_size, p);

  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_out[((size_t)t * C + c) * P + p];
  const float glt = g_logt[(size_t)t * P + p];
  const float logt_fin = logt[(size_t)t * P + p];
  const float t_fin = expf(logt_fin);
  float S = 0.0f;

  for (int b = b_end - 1; b >= b_begin; --b) {
    const float log_in = carry[(size_t)b * P + p];
    float* dst = dtab + (size_t)b * B * W;
    const int open = __syncthreads_or(log_in > kTEpsLog);
    if (blk_count[b] <= 0 || !open) {
      for (int i = p; i < B * W; i += P) dst[i] = 0.0f;
      continue;
    }
    fs::stage_rows(s_tab, table + (size_t)b * B * W, B * W, p, P);
    __syncthreads();
    // exit log T of this block: the next block's carry, or the final log T
    const float L = (b + 1 < b_end) ? carry[(size_t)(b + 1) * P + p] : logt_fin;
    S = fs::block_backward<C>(s_tab, s_part, dst, B, px, g, glt, t_fin, L, S);
  }
}

}  // namespace

extern "C" int fs_flat_composite_fwd(const float* table, const int* runs,
                                     const int* blk_count,
                                     float* out, float* logt, float* carry,
                                     int num_ctas, int tiles_x, int tile_size,
                                     int B, int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  const int P = tile_size * tile_size;
  const size_t smem = (size_t)B * (8 + C) * sizeof(float);
  flat_fwd_kernel<8><<<num_ctas, P, smem, (cudaStream_t)stream>>>(
      table, runs, blk_count, out, logt, carry, tiles_x, tile_size,
      B);
  return (int)cudaGetLastError();
}

extern "C" int fs_flat_composite_bwd(const float* table, const int* runs,
                                     const int* blk_count,
                                     const float* g_out, const float* g_logt,
                                     const float* logt, const float* carry,
                                     float* dtab, int num_ctas, int tiles_x,
                                     int tile_size, int B, int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  const int P = tile_size * tile_size;
  const size_t smem =
      ((size_t)B * (8 + C) + (size_t)fs::reduce_floats(P, C)) * sizeof(float);
  flat_bwd_kernel<8><<<num_ctas, P, smem, (cudaStream_t)stream>>>(
      table, runs, blk_count, g_out, g_logt, logt, carry, dtab,
      tiles_x, tile_size, B);
  return (int)cudaGetLastError();
}
