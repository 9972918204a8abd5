// SSIM on Hopper: one forward kernel (the five filtered moments, the SSIM
// map's partial sums and, when a gradient is wanted, the three derivative
// maps) with a one-CTA launch after it for the mean, and one backward
// kernel (the transposed window over those maps, and the render's
// gradient).
//
// Replaces no TPU kernel: the JAX package leaves the window to XLA as two
// banded matrix products per call (fusionsense_tpu/train/losses.py
// _filter2d_batch), which suits the MXU. Here those products multiply ~99%
// zeros (~20 GFLOP a step at 640x480x3, forward and backward), and eager
// PyTorch launched ~100 kernels around them.
//
// What bounds it on the H100: bytes. The forward reads two (H, W, C) images
// (3.69 MB each at 640x480x3) and, when a gradient is wanted, writes three
// maps over the VALID output, (3, C, H - 10, W - 10) floats (10.7 MB):
// 2.2-5.4 us at 3.35 TB/s; its ~0.2 GFLOP take 3 us at 67 TFLOP/s. The
// backward reads the maps and both images and writes the gradient (21.7 MB,
// 6.5 us). So the five moments and the SSIM map never reach device memory:
// each CTA owns a 32x32 tile of one channel, loads that tile of both images
// with its 10-pixel halo into shared memory once, runs the horizontal
// 11-tap pass of the five moments into shared memory and the vertical pass
// in registers, and forms the SSIM value (and the maps) per output pixel.
// The backward's CTA owns a 32x32 tile of input pixels of one channel and
// loads the maps over its tile and the halo before it, zero outside the
// VALID output.
//
// The mean: each forward CTA reduces its pixels in double, in a fixed
// order, and writes one partial; a second launch of one CTA sums the
// partials in a fixed order. No float atomics and no state kept between
// calls, so the loss is the same to the bit from run to run, a CUDA graph
// can replay both launches, and calls on several streams may overlap. The
// cotangent is read from device memory: no host sync anywhere.
//
// The arithmetic is in ssim.cuh; the C entry points there pack their
// arguments and call run_fwd / run_bwd below, which launch on the caller's
// stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include "ssim.cuh"

namespace {

using fs_ssim::kHalo;
using fs_ssim::kMaps;
using fs_ssim::kMoments;

constexpr int kTile = 32;                 // a CTA's tile, as in
                                          // train/ssim_kernels.py
constexpr int kRows = 8;                  // thread rows: 32 x 8 threads
constexpr int kThreads = kTile * kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kIn = kTile + kHalo;        // a tile with its halo

__device__ double block_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  double s = 0.0;
  if (tid == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;   // thread 0's is the sum
}

__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const fs_ssim::Args A) {
  __shared__ float sa[kIn][kIn];
  __shared__ float sb[kIn][kIn];
  __shared__ float sh[kMoments][kIn][kTile];
  __shared__ double red[kWarps];
  const int Ho = fs_ssim::out_h(A), Wo = fs_ssim::out_w(A);
  const int c = blockIdx.z, ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, tid = threadIdx.y * kTile + tx;

  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn, j = i % kIn, y = oy0 + r, x = ox0 + j;
    float va = 0.0f, vb = 0.0f;
    if (y < A.H && x < A.W) {
      const size_t at = ((size_t)y * A.W + x) * A.C + c;
      va = A.a[at];
      vb = A.b[at];
    }
    sa[r][j] = va;
    sb[r][j] = vb;
  }
  __syncthreads();

  for (int r = threadIdx.y; r < kIn; r += kRows) {
    float m[kMoments];
    fs_ssim::hmoments(&sa[r][tx], &sb[r][tx], A.k, m);
    for (int q = 0; q < kMoments; ++q) sh[q][r][tx] = m[q];
  }
  __syncthreads();

  const int ox = ox0 + tx;
  const size_t per_map = fs_ssim::out_n(A);
  double sum = 0.0;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int oy = oy0 + i;
    if (oy >= Ho || ox >= Wo) continue;
    float m[kMoments], d[kMaps];
    for (int q = 0; q < kMoments; ++q)
      m[q] = fs_ssim::tap(&sh[q][i][tx], kTile, A.k);
    sum += fs_ssim::pixel(m, A.c1, A.c2, A.maps ? d : nullptr);
    if (A.maps) {
      const size_t at = ((size_t)c * Ho + oy) * Wo + ox;
      for (int q = 0; q < kMaps; ++q) A.maps[q * per_map + at] = d[q];
    }
  }

  const unsigned int bid = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                           + blockIdx.x;
  sum = block_sum(sum, red);
  if (tid == 0) A.part[bid] = sum;
}

// One CTA: the mean of the forward's `blocks` partials, summed in a fixed
// order.
__global__ void __launch_bounds__(kThreads)
    mean_kernel(const fs_ssim::Args A, unsigned int blocks) {
  __shared__ double red[kWarps];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  double acc = 0.0;
  for (unsigned int i = tid; i < blocks; i += kThreads) acc += A.part[i];
  acc = block_sum(acc, red);
  if (tid == 0) *A.loss = (float)(acc / (double)fs_ssim::out_n(A));
}

__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const fs_ssim::Args A) {
  __shared__ float sm[kMaps][kIn][kIn];
  __shared__ float sh[kMaps][kIn][kTile];
  const int Ho = fs_ssim::out_h(A), Wo = fs_ssim::out_w(A);
  const int c = blockIdx.z, x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, tid = threadIdx.y * kTile + tx;
  const size_t per_map = fs_ssim::out_n(A);

  // the maps at output rows y0 - 10 .. y0 + 31 and columns x0 - 10 ..
  // x0 + 31: the windows that cover the tile's pixels
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn, j = i % kIn;
    const int oy = y0 - kHalo + r, ox = x0 - kHalo + j;
    const bool in = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
    const size_t at = in ? ((size_t)c * Ho + oy) * Wo + ox : 0;
    for (int q = 0; q < kMaps; ++q)
      sm[q][r][j] = in ? A.maps[q * per_map + at] : 0.0f;
  }
  __syncthreads();

  for (int r = threadIdx.y; r < kIn; r += kRows)
    for (int q = 0; q < kMaps; ++q)
      sh[q][r][tx] = fs_ssim::tap_back(&sm[q][r][tx + kHalo], 1, A.k);
  __syncthreads();

  const int x = x0 + tx;
  if (x >= A.W) return;
  const float scale = A.g[0] / (float)per_map;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int y = y0 + i;
    if (y >= A.H) break;
    float f[kMaps];
    for (int q = 0; q < kMaps; ++q)
      f[q] = fs_ssim::tap_back(&sh[q][i + kHalo][tx], kTile, A.k);
    const size_t at = ((size_t)y * A.W + x) * A.C + c;
    A.da[at] = fs_ssim::grad(f, A.a[at], A.b[at], scale);
  }
}

dim3 grid_of(int h, int w, int C) {
  return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, C);
}

}  // namespace

namespace fs_ssim {

int run_fwd(const Args& A, void* stream) {
  const dim3 grid = grid_of(out_h(A), out_w(A), A.C);
  fwd_kernel<<<grid, dim3(kTile, kRows), 0, (cudaStream_t)stream>>>(A);
  mean_kernel<<<1, dim3(kTile, kRows), 0, (cudaStream_t)stream>>>(
      A, grid.x * grid.y * grid.z);
  return (int)cudaGetLastError();
}

int run_bwd(const Args& A, void* stream) {
  bwd_kernel<<<grid_of(A.H, A.W, A.C), dim3(kTile, kRows), 0,
               (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace fs_ssim
