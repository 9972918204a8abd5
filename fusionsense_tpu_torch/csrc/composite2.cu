// Dense per-tile compositing on Hopper: kernels K3 (forward) and K4
// (backward) of the `pallas` rasterizer backend.
//
// Replaces: fusionsense_tpu/render/pallas_composite2.py, functions
// _fwd_kernel (K3) and _bwd_kernel (K4).
//
// What bounds it on the H100: operations. Every composited (pair, pixel)
// costs two transcendentals and ~40 FP32 operations forward, ~90 backward,
// against a table of T * K * 64 bytes read once; the backward also reduces
// 14 sums per pair over the tile's pixels. A tile holds at most K pairs, so
// one CTA's walk is bounded by K / 128 chunks: the dense layout has no
// hot-tile run of the flat one, at the price of a (T, K) table.
//
// Design:
// - ONE CTA per tile, one thread per pixel (P = tile_size^2 threads); log T
//   and the backward's suffix sum live in registers. tile_ids gives each
//   table row's GLOBAL tile and through it the pixel coordinates, so a
//   tile-sharded caller can composite an offset slice.
// - K3 walks the tile's 128-pair chunks in order while
//   c < ceil(count / B) and some pixel of the tile still has
//   log T > -9.21: the Pallas while_loop's cond, taken as a block-wide vote
//   (__syncthreads_or) before each chunk, never per pixel. It stores the
//   log T entering each composited chunk (`carries`), zero for the chunks
//   it did not composite, and the number composited, nused (T,) int32.
// - K4 zeroes the gradient rows of every chunk past nused (all K rows of a
//   tile with count 0), then walks the nused chunks in reverse. Instead of
//   the reference's prefix matmul from carries[c], it recovers T_excl by
//   walking back from the chunk's exit log T (carries[c + 1], or the final
//   log T for the last one), as K2 does. Each gradient row belongs to one
//   tile, so no atomics are needed.
// - Each chunk's rows (B x (8 + C) floats, 8 KB at C = 8) are staged in
//   shared memory and read as broadcasts. The alpha math and the walks over
//   one staged chunk are composite_common.cuh's, shared with K1/K2.
//
// Plain C entry points (bound with ctypes) launch on the caller's stream
// and return cudaGetLastError().

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using fs::kTEpsLog;
using fs::Pixel;

template <int C>
__global__ void dense_fwd_kernel(const float* __restrict__ table,
                                 const int* __restrict__ counts,
                                 const int* __restrict__ tile_ids,
                                 float* __restrict__ out,
                                 float* __restrict__ logt_out,
                                 float* __restrict__ carries,
                                 int* __restrict__ nused, int tiles_x,
                                 int tile_size, int K, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float s_tab[];  // B * W
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int nc = K / B;
  const int n_chunks = min(max((counts[t] + B - 1) / B, 0), nc);
  const Pixel px = fs::pixel_of(tile_ids[t], tiles_x, tile_size, p);
  const float* tab = table + (size_t)t * K * W;
  float* carry = carries + (size_t)t * nc * P;

  float log_t = 0.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  int chunk = 0;
  for (; chunk < n_chunks; ++chunk) {
    // barrier too: nobody still reads the previous chunk's rows
    if (!__syncthreads_or(log_t > kTEpsLog)) break;   // uniform over the CTA
    carry[(size_t)chunk * P + p] = log_t;
    fs::stage_rows(s_tab, tab + (size_t)chunk * B * W, B * W, p, P);
    __syncthreads();
    fs::composite_block<C>(s_tab, B, px, log_t, acc);
  }
  for (int r = chunk; r < nc; ++r) carry[(size_t)r * P + p] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) out[((size_t)t * C + c) * P + p] = acc[c];
  logt_out[(size_t)t * P + p] = log_t;
  if (p == 0) nused[t] = chunk;
}

template <int C>
__global__ void dense_bwd_kernel(const int* __restrict__ neff,
                                 const int* __restrict__ tile_ids,
                                 const float* __restrict__ table,
                                 const float* __restrict__ g_out,
                                 const float* __restrict__ g_logt,
                                 const float* __restrict__ logt,
                                 const float* __restrict__ carries,
                                 float* __restrict__ dtab, int tiles_x,
                                 int tile_size, int K, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float smem[];
  float* s_tab = smem;                 // B * W
  float* s_part = smem + B * W;        // fs::reduce_floats(P, C)
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int nc = K / B;
  const int n_eff = min(max(neff[t], 0), nc);
  float* dtile = dtab + (size_t)t * K * W;
  const float* carry = carries + (size_t)t * nc * P;

  // chunks the forward never composited get zero rows
  for (int i = n_eff * B * W + p; i < K * W; i += P) dtile[i] = 0.0f;
  if (n_eff == 0) return;              // uniform over the CTA

  const Pixel px = fs::pixel_of(tile_ids[t], tiles_x, tile_size, p);
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_out[((size_t)t * C + c) * P + p];
  const float glt = g_logt[(size_t)t * P + p];
  const float logt_fin = logt[(size_t)t * P + p];
  const float t_fin = expf(logt_fin);
  float S = 0.0f;

  // block_backward ends on a barrier, so each chunk may be staged at once
  for (int chunk = n_eff - 1; chunk >= 0; --chunk) {
    fs::stage_rows(s_tab, table + ((size_t)t * K + (size_t)chunk * B) * W,
                   B * W, p, P);
    __syncthreads();
    // exit log T of this chunk: the next chunk's carry, or the final log T
    const float L = (chunk + 1 < n_eff) ? carry[(size_t)(chunk + 1) * P + p]
                                        : logt_fin;
    S = fs::block_backward<C>(s_tab, s_part, dtile + (size_t)chunk * B * W,
                              B, px, g, glt, t_fin, L, S);
  }
}

}  // namespace

extern "C" int fs_composite2_fwd(const float* table, const int* counts,
                                 const int* tile_ids, float* out, float* logt,
                                 float* carries, int* nused, int num_tiles,
                                 int tiles_x, int tile_size, int K, int B,
                                 int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const int P = tile_size * tile_size;
  const size_t smem = (size_t)B * (8 + C) * sizeof(float);
  dense_fwd_kernel<8><<<num_tiles, P, smem, (cudaStream_t)stream>>>(
      table, counts, tile_ids, out, logt, carries, nused, tiles_x, tile_size,
      K, B);
  return (int)cudaGetLastError();
}

extern "C" int fs_composite2_bwd(const int* neff, const int* tile_ids,
                                 const float* table, const float* g_out,
                                 const float* g_logt, const float* logt,
                                 const float* carries, float* dtab,
                                 int num_tiles, int tiles_x, int tile_size,
                                 int K, int B, int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  const int P = tile_size * tile_size;
  const size_t smem =
      ((size_t)B * (8 + C) + (size_t)fs::reduce_floats(P, C)) * sizeof(float);
  dense_bwd_kernel<8><<<num_tiles, P, smem, (cudaStream_t)stream>>>(
      neff, tile_ids, table, g_out, g_logt, logt, carries, dtab, tiles_x,
      tile_size, K, B);
  return (int)cudaGetLastError();
}
