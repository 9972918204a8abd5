// Device code shared by the compositing kernels on Hopper: K1/K2 of the
// flat layout (flat_composite.cu) and K3/K4 of the dense (T, K) layout
// (composite2.cu).
//
// Both layouts stage 128-pair blocks of [mx, my, ca, cb, cc, log_op,
// abs_tap_x, abs_tap_y, chan...] rows in shared memory and walk them with
// one thread per pixel of the CTA's tile, so the per-pair alpha (the math of
// fusionsense_tpu/render/pallas_composite2.py::_alpha_of_chunk), the forward
// walk over one staged block and the backward walk with its per-pair sums
// over the tile's pixels are written once, here.
//
// The walks take a compile-time flag BF16, the counterpart of the Pallas
// kernels' blend_bf16 branch: each operand of the blend products (forward
// acc = chan^T w; backward q = chan g_out and d chan = w g_out^T) is
// rounded to bfloat16 (round to nearest even) and back, and the products
// are accumulated in float32, as jnp.dot(..., preferred_element_type=
// float32) does on bf16 operands (the product of two bf16 values is exact
// in float32). w is rounded after it is formed as alpha * T_excl; the alpha
// math, log T, the suffix (a sum of w * q with w float32, as in the
// reference's backward) and every other term stay float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fs {

constexpr float kTEpsLog = -9.21f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kLogAlphaMax = -0.0010005003335835344f;   // log(0.999)
constexpr int kGroup = 16;     // pairs per cross-warp reduction pass

struct Pixel {
  float px, py;
};

__device__ __forceinline__ Pixel pixel_of(int tile, int tiles_x,
                                          int tile_size, int p) {
  Pixel r;
  r.px = (float)((tile % tiles_x) * tile_size) + (float)(p % tile_size) + 0.5f;
  r.py = (float)((tile / tiles_x) * tile_size) + (float)(p / tile_size) + 0.5f;
  return r;
}

// alpha of one table row at one pixel; NaN propagates as in the reference
// (jnp.minimum), so a poisoned parameter still reaches the step guard.
__device__ __forceinline__ float alpha_of(const float* row, Pixel px,
                                          float* dx_out, float* dy_out,
                                          bool* alive) {
  const float dx = px.px - row[0];
  const float dy = px.py - row[1];
  const float power =
      -(0.5f * row[2] * dx * dx + row[3] * dx * dy + 0.5f * row[4] * dy * dy) +
      row[5];
  const float clipped = (power > kLogAlphaMax) ? kLogAlphaMax : power;
  const float alpha_raw = expf(clipped);
  *alive = (alpha_raw >= kAlphaMin) && (power < kLogAlphaMax);
  *dx_out = dx;
  *dy_out = dy;
  return (alpha_raw < kAlphaMin) ? 0.0f : alpha_raw;
}

// x rounded to bfloat16 (nearest even) and back when BF16, else x.
template <bool BF16>
__device__ __forceinline__ float blend_operand(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ void stage_rows(float* s_tab, const float* src,
                                           int n, int tid, int nthreads) {
  for (int i = tid; i < n; i += nthreads) s_tab[i] = src[i];
}

// Shared-memory floats the backward needs beside the staged rows.
__host__ __device__ constexpr int reduce_floats(int P, int C) {
  return (P / 32) * kGroup * (6 + C);
}

// Forward over one staged block of B rows at this thread's pixel: blends
// the channels into acc and advances log T by the block's sum of
// log1p(-alpha) (the reference's prefix matmul, walked in order). Under
// BF16 it also sums sacc, the blend with w left float32 (the channels
// rounded): the backward's suffix S is a sum of w * q with w float32 in the
// reference, and reads sacc instead of acc.
template <int C, bool BF16>
__device__ __forceinline__ void composite_block(const float* s_tab, int B,
                                                Pixel px, float& log_t,
                                                float (&acc)[C],
                                                float (&sacc)[C]) {
  constexpr int W = 8 + C;
  float cum = 0.0f;
  for (int j = 0; j < B; ++j) {
    const float* row = s_tab + j * W;
    float dx, dy;
    bool alive;
    const float alpha = alpha_of(row, px, &dx, &dy, &alive);
    const float lg = log1pf(-alpha);
    cum += lg;
    const float wf = alpha * expf(log_t + cum - lg);
    const float w = blend_operand<BF16>(wf);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float ch = blend_operand<BF16>(row[8 + c]);
      acc[c] += ch * w;
      if constexpr (BF16) sacc[c] += ch * wf;
    }
  }
  log_t += cum;
}

// One step of the transposing butterfly: the lanes on either side of the
// xor distance 2 * HALF each keep the HALF sums their side owns (the upper
// side the upper half) and send the other HALF to the partner, so the
// step costs HALF shuffles and leaves HALF values per lane.
template <int HALF>
__device__ __forceinline__ void fold_half(float (&v)[16], int lane) {
  const bool upper = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// The warp's sums of 16 values per lane, with 8 + 4 + 2 + 1 + 1 = 16
// shuffles (a butterfly per value takes 5 of them). Returns in lanes 2k
// and 2k + 1 the sum over the warp of v[k], the same bits in both; the
// order of the additions is fixed.
__device__ __forceinline__ float warp_sums16(float (&v)[16], int lane) {
  fold_half<8>(v, lane);
  fold_half<4>(v, lane);
  fold_half<2>(v, lane);
  fold_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Backward over one staged block of B rows (B a multiple of kGroup), called
// by every thread of the CTA. The block is walked in reverse from its exit
// log T `L` (T_excl is recovered by subtracting log1p(-alpha) pair by pair,
// so no per-pair state is stored); S is the sum of w * q over the pairs
// behind this block, and the return value is S extended by this block.
// Each pair has 6 + C sums over the tile's pixels (d mx, d my, d ca, d cb,
// d cc, d log_op, d chan[C]: 14 at C = 8). Within a warp they are padded to
// 16 and reduced by warp_sums16's transposing butterfly, 16 shuffles per
// pair instead of 70 for a butterfly per sum; shuffles run at a quarter of
// the FP32 rate, so 70 shuffles would cost about three times the pair's
// arithmetic. The lanes that end up holding the sums store them at
// once.
// A warp whose pixels all have alpha = 0 for a pair skips its shuffles
// (every term is exactly zero). One shared-memory pass over the warps then
// sums kGroup pairs at a time and writes the block's B gradient rows to
// dst: d mx, d my, d ca, d cb, d cc, d log_op, |d mx|, |d my|, d chan.
// Ends on a barrier, so s_tab may be restaged at once.
template <int C, bool BF16>
__device__ __forceinline__ float block_backward(
    const float* s_tab, float* s_part, float* dst, int B, Pixel px,
    const float (&g)[C], float glt, float t_fin, float L, float S) {
  constexpr int W = 8 + C;
  constexpr int NRED = 6 + C;   // d_mx d_my d_ca d_cb d_cc d_lo d_chan[C]
  static_assert(NRED <= 16, "warp_sums16 reduces at most 16 sums");
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = P >> 5;
  float suffix_acc = S;
  float gb[C];   // the cotangent as the blend products take it
#pragma unroll
  for (int c = 0; c < C; ++c) gb[c] = blend_operand<BF16>(g[c]);

  for (int g0 = B - kGroup; g0 >= 0; g0 -= kGroup) {
    for (int jj = kGroup - 1; jj >= 0; --jj) {
      const float* row = s_tab + (g0 + jj) * W;
      float dx, dy;
      bool alive;
      const float alpha = alpha_of(row, px, &dx, &dy, &alive);
      const float lg = log1pf(-alpha);
      const float t_excl = expf(L - lg);
      L -= lg;
      const float w = alpha * t_excl;
      float q = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) q += blend_operand<BF16>(row[8 + c]) * gb[c];
      const float a = w * q;
      const float suffix = suffix_acc;
      suffix_acc += a;
      const float inv1m = 1.0f / (1.0f - alpha);
      const float d_alpha = q * t_excl - suffix * inv1m - glt * t_fin * inv1m;
      const float d_power = alive ? alpha * d_alpha : 0.0f;
      float sum = 0.0f;
      if (__any_sync(0xffffffffu, alpha != 0.0f)) {
        const float ca = row[2], cb = row[3], cc = row[4];
        float v[16];
        v[0] = d_power * (ca * dx + cb * dy);
        v[1] = d_power * (cb * dx + cc * dy);
        v[2] = d_power * (-0.5f * dx * dx);
        v[3] = d_power * (-dx * dy);
        v[4] = d_power * (-0.5f * dy * dy);
        v[5] = d_power;
        const float wb = blend_operand<BF16>(w);
#pragma unroll
        for (int c = 0; c < C; ++c) v[6 + c] = wb * gb[c];
#pragma unroll
        for (int k = NRED; k < 16; ++k) v[k] = 0.0f;
        sum = warp_sums16(v, lane);
      }
      const int k = lane >> 1;
      if (!(lane & 1) && k < NRED) s_part[(warp * kGroup + jj) * NRED + k] = sum;
    }
    __syncthreads();
    for (int i = p; i < kGroup * NRED; i += P) {
      const int jj = i / NRED;
      const int k = i % NRED;
      float sum = 0.0f;
      for (int w8 = 0; w8 < nwarps; ++w8)
        sum += s_part[(w8 * kGroup + jj) * NRED + k];
      float* rowp = dst + (g0 + jj) * W;
      if (k < 6) {
        rowp[k] = sum;
        if (k < 2) rowp[6 + k] = fabsf(sum);
      } else {
        rowp[k + 2] = sum;
      }
    }
    __syncthreads();
  }
  return suffix_acc;
}

}  // namespace fs
