// Dense per-tile compositing on Hopper: kernels K3 (forward) and K4
// (backward) of the `pallas` rasterizer backend.
//
// Replaces: fusionsense_tpu/render/pallas_composite2.py, functions
// _fwd_kernel (K3) and _bwd_kernel (K4).
//
// What bounds it on the H100: operations. Every composited (pair, pixel)
// costs two transcendentals and ~40 FP32 operations forward, ~90 backward,
// against a table of T * K * 64 bytes read once; the backward also reduces
// 14 sums per pair over the tile's pixels. The Pallas grid walks each
// tile's 128-pair chunks in order, carrying log T (backward: the suffix S)
// from chunk to chunk, and stops at the first chunk c with
// c >= ceil(count / B) or every pixel's log T <= -9.21. Tiles are very
// uneven: at the dn_splatter preset's 640x480 shape two thirds of the
// tiles composite nothing and one in seven walks all K / B chunks. One CTA
// per tile walking its chunks in series would leave ~3 working CTAs per
// SM, too few to hide each pixel's serial exp/log1p chain, and the longest
// walks would set the time. So no CTA composites more than one chunk.
//
// Design. A chunk entered at per-pixel log T `L` adds exp(L) * acc_c to the
// output and delta_c to log T, where acc_c = sum_j alpha_j exp(cum_j - lg_j)
// chan_j and delta_c = sum_j lg_j (lg = log1p(-alpha), cum its inclusive
// prefix) are the chunk's own, taken from T = 1: neither depends on L. So
// K3 and K4 are two launches each:
//  1. fwd_chunks: one CTA per (tile, chunk), one thread per pixel. A CTA
//     with c >= ceil(count / B) returns at once; the others composite their
//     chunk from log T = 0 and write delta (T, K/B, P) and acc
//     (T, K/B, C, P). The chunks past the stop rule are composited too (the
//     pass cannot know the stop); the combine never reads their results.
//  2. fwd_combine: one CTA per tile applies the reference's stop rule: it
//     walks c = 0, 1, ... while c < ceil(count / B) and the whole-tile vote
//     max_p L > -9.21 holds (a NaN in L fails it, as jnp.max gives NaN),
//     sets carries[c] = L, adds exp(L) * acc_c to out and delta_c to L. It
//     writes log T = L, nused = c and zero carries past nused. delta is
//     added in the order of the reference's log_t += cum, so the carries
//     and nused are those of a single walk. A tile has at most K / B
//     chunks, so this walk is light.
//  3. bwd_suffix: one thread per (tile, pixel) walks the tile's nused
//     chunks in reverse: S_c = sum of exp(carries[c']) * sum_ch
//     g_out[ch] * acc_c'[ch] over the later chunks c' < nused, which is
//     the reference's carried sum of w * q, with no alpha recomputed. It is
//     a launch of its own, as in the flat layout, so that every chunk's
//     CTA in pass 4 reads one S instead of walking the later chunks' state,
//     and so that the stage can be held against its plain twin.
//  4. bwd_chunks: one CTA per (tile, chunk). A chunk at or past nused
//     writes its B zero gradient rows and returns; the others stage their
//     rows and run block_backward (composite_common.cuh) from S_c and the
//     chunk's exit log T (carries[c + 1], or the final log T for the last).
// Each output row has one writer and every sum is taken in a fixed order:
// no atomics, and the result is deterministic. delta, acc and S are left
// unwritten where nothing reads them (chunks past ceil(count / B), and
// past nused for S). tile_ids gives each table row's GLOBAL tile and
// through it the pixel coordinates, so a tile-sharded caller can composite
// an offset slice. Each chunk's rows (B x (8 + C) floats, 8 KB at C = 8)
// are staged in shared memory and read as broadcasts.
//
// Plain C entry points (bound with ctypes) launch on the caller's stream
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "composite_common.cuh"

namespace {

using fs::kTEpsLog;

// ceil(count / B) of tile t, clipped to the nc chunks the table holds.
__device__ __forceinline__ int chunks_of(const int* counts, int t, int B,
                                         int nc) {
  return min(max((counts[t] + B - 1) / B, 0), nc);
}

template <int C>
__global__ void fwd_chunks_kernel(const float* __restrict__ table,
                                  const int* __restrict__ counts,
                                  const int* __restrict__ tile_ids,
                                  float* __restrict__ delta,
                                  float* __restrict__ acc_out, int tiles_x,
                                  int tile_size, int K, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float s_tab[];   // B * W
  const int nc = K / B;
  const int t = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  if (c >= chunks_of(counts, t, B, nc)) return;   // uniform over the CTA
  const int p = threadIdx.x;
  const int P = blockDim.x;
  fs::stage_rows(s_tab, table + ((size_t)t * K + (size_t)c * B) * W, B * W,
                 p, P);
  __syncthreads();
  float log_t = 0.0f;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  fs::composite_block<C>(s_tab, B,
                         fs::pixel_of(tile_ids[t], tiles_x, tile_size, p),
                         log_t, acc);
  const size_t tc = (size_t)t * nc + c;
  delta[tc * P + p] = log_t;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc_out[(tc * C + ch) * P + p] = acc[ch];
}

template <int C>
__global__ void fwd_combine_kernel(const float* __restrict__ delta,
                                   const float* __restrict__ acc,
                                   const int* __restrict__ counts,
                                   float* __restrict__ out,
                                   float* __restrict__ logt,
                                   float* __restrict__ carries,
                                   int* __restrict__ nused, int nc, int B) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int n_chunks = chunks_of(counts, t, B, nc);
  float L = 0.0f;
  float o[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) o[ch] = 0.0f;
  int c = 0;
  for (; c < n_chunks; ++c) {
    const size_t tc = (size_t)t * nc + c;
    // loaded before the vote so the reads overlap it; a chunk past the
    // stop is read but never used (it may hold a NaN the reference never
    // saw)
    const float d = delta[tc * P + p];
    float a[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a[ch] = acc[(tc * C + ch) * P + p];
    // the reference's cond, jnp.max(log_t) > -9.21, taken over the CTA
    if (!(__syncthreads_or(L > kTEpsLog) && !__syncthreads_or(isnan(L))))
      break;   // uniform over the CTA
    carries[tc * P + p] = L;
    const float e = expf(L);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] += e * a[ch];
    L += d;
  }
  for (int r = c; r < nc; ++r) carries[((size_t)t * nc + r) * P + p] = 0.0f;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[((size_t)t * C + ch) * P + p] = o[ch];
  logt[(size_t)t * P + p] = L;
  if (p == 0) nused[t] = c;
}

template <int C>
__global__ void bwd_suffix_kernel(const float* __restrict__ acc,
                                  const float* __restrict__ carries,
                                  const int* __restrict__ nused,
                                  const float* __restrict__ g_out,
                                  float* __restrict__ S, int nc) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int n = min(max(nused[t], 0), nc);
  float g[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) g[ch] = g_out[((size_t)t * C + ch) * P + p];
  float s = 0.0f;
  for (int c = n - 1; c >= 0; --c) {   // last chunk first, as the reference
    const size_t tc = (size_t)t * nc + c;
    S[tc * P + p] = s;
    float q = 0.0f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) q += g[ch] * acc[(tc * C + ch) * P + p];
    s += expf(carries[tc * P + p]) * q;
  }
}

template <int C>
__global__ void bwd_chunks_kernel(const float* __restrict__ table,
                                  const int* __restrict__ nused,
                                  const int* __restrict__ tile_ids,
                                  const float* __restrict__ g_out,
                                  const float* __restrict__ g_logt,
                                  const float* __restrict__ logt,
                                  const float* __restrict__ carries,
                                  const float* __restrict__ S,
                                  float* __restrict__ dtab, int tiles_x,
                                  int tile_size, int K, int B) {
  constexpr int W = 8 + C;
  extern __shared__ float smem[];
  float* s_tab = smem;                 // B * W
  float* s_part = smem + B * W;        // fs::reduce_floats(P, C)
  const int nc = K / B;
  const int t = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int n = min(max(nused[t], 0), nc);
  float* dst = dtab + ((size_t)t * K + (size_t)c * B) * W;
  if (c >= n) {   // uniform over the CTA: a chunk the forward never used
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = p; i < B * W / 4; i += P)
      d4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  fs::stage_rows(s_tab, table + ((size_t)t * K + (size_t)c * B) * W, B * W,
                 p, P);
  float g[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) g[ch] = g_out[((size_t)t * C + ch) * P + p];
  const float glt = g_logt[(size_t)t * P + p];
  const float logt_fin = logt[(size_t)t * P + p];
  const size_t tc = (size_t)t * nc + c;
  // exit log T of this chunk: the next chunk's carry, or the final log T
  const float L = (c + 1 < n) ? carries[(tc + 1) * P + p] : logt_fin;
  const float s = S[tc * P + p];
  __syncthreads();
  fs::block_backward<C>(s_tab, s_part, dst, B,
                        fs::pixel_of(tile_ids[t], tiles_x, tile_size, p), g,
                        glt, expf(logt_fin), L, s);
}

}  // namespace

extern "C" int fs_dense_fwd_chunks(const float* table, const int* counts,
                                   const int* tile_ids, float* delta,
                                   float* acc, int num_tiles, int tiles_x,
                                   int tile_size, int K, int B, int C,
                                   void* stream) {
  if (C != 8 || (B * (8 + C)) % 4) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || K == 0) return 0;
  fwd_chunks_kernel<8><<<num_tiles * (K / B), tile_size * tile_size,
                         (size_t)B * (8 + C) * sizeof(float),
                         (cudaStream_t)stream>>>(
      table, counts, tile_ids, delta, acc, tiles_x, tile_size, K, B);
  return (int)cudaGetLastError();
}

extern "C" int fs_dense_fwd_combine(const float* delta, const float* acc,
                                    const int* counts, float* out,
                                    float* logt, float* carries, int* nused,
                                    int num_tiles, int P, int nc, int B,
                                    int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  fwd_combine_kernel<8><<<num_tiles, P, 0, (cudaStream_t)stream>>>(
      delta, acc, counts, out, logt, carries, nused, nc, B);
  return (int)cudaGetLastError();
}

extern "C" int fs_dense_bwd_suffix(const float* acc, const float* carries,
                                   const int* nused, const float* g_out,
                                   float* S, int num_tiles, int P, int nc,
                                   int C, void* stream) {
  if (C != 8) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return 0;
  bwd_suffix_kernel<8><<<num_tiles, P, 0, (cudaStream_t)stream>>>(
      acc, carries, nused, g_out, S, nc);
  return (int)cudaGetLastError();
}

extern "C" int fs_dense_bwd_chunks(const float* table, const int* nused,
                                   const int* tile_ids, const float* g_out,
                                   const float* g_logt, const float* logt,
                                   const float* carries, const float* S,
                                   float* dtab, int num_tiles, int tiles_x,
                                   int tile_size, int K, int B, int C,
                                   void* stream) {
  if (C != 8 || (B * (8 + C)) % 4) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0 || K == 0) return 0;
  const int P = tile_size * tile_size;
  const size_t smem =
      ((size_t)B * (8 + C) + (size_t)fs::reduce_floats(P, C)) * sizeof(float);
  bwd_chunks_kernel<8><<<num_tiles * (K / B), P, smem,
                         (cudaStream_t)stream>>>(
      table, nused, tile_ids, g_out, g_logt, logt, carries, S, dtab, tiles_x,
      tile_size, K, B);
  return (int)cudaGetLastError();
}
