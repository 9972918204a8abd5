// The rasterizer's per-Gaussian preprocess on Hopper: one forward kernel
// (the EWA projection, the view-dependent SH colour and the blended
// channels) and one backward kernel (every input's gradient).
//
// Replaces no TPU kernel: the JAX package leaves this chain
// (fusionsense_tpu/render/project.py, core/sh.py and the channels of
// render/rasterize.py) to XLA, which fuses it into a few loops. Eager
// PyTorch has no such fusion: the composition launched ~340 kernels
// forward and ~620 under autograd, each a pass over N-long arrays, so at
// the benchmark's N (~25,000) the chain cost launches, not bytes.
//
// What bounds it on the H100: bytes. A Gaussian reads 256 bytes forward
// (means, quaternion, scales, opacity, 48 SH floats, normal, tap, ~200
// FP32 operations) and writes 73; the backward reads the inputs again
// (236 bytes) plus up to 68 bytes of cotangents and writes 248 (the SH
// gradient is 192). At N = 24,576 that is 8.1 MB and 13.2 MB: 2.4 and
// 3.9 µs at 3.35 TB/s, below a launch's own cost. So each pass is one launch, one thread per Gaussian
// (128 a CTA), which recomputes the forward's intermediates from the saved
// inputs rather than reading them back: recomputing costs ~250 FP32
// operations a Gaussian, reading them back ~400 bytes. The loads of a
// Gaussian's rows are strided by the row width across a warp; each thread
// then reads the rest of its rows from the lines the first loads brought
// into L1, so the traffic stays near one pass over the bytes.
//
// d viewmat (camera optimisation) is a sum over every Gaussian: each CTA
// reduces its threads' 12 partials (dR, dt) in shared memory in a fixed
// order and writes one row, and a second launch of 12 CTAs sums the rows in
// a fixed order. No atomics: the result is deterministic. Without a
// viewmat gradient the second launch does not run.
//
// The camera (viewmat, fx, fy, cx, cy) is read from device memory: no host
// sync, so a CUDA graph can capture the launches. The arithmetic is in
// preprocess.cuh, which states which autograd rule each step mirrors.
//
// The C entry points (in preprocess.cuh, which packs their arguments) launch
// on the caller's stream through run_fwd / run_bwd below and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "preprocess.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCamTerms = 12;   // dR row-major, dt
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const fs_pre::Args A) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= A.n) return;
  const fs_pre::Cam c = fs_pre::load_cam(A);
  fs_pre::fwd_gaussian(A, c, i);
}

template <bool CAM>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const fs_pre::Args A, float* cam_part) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float dcam[kCamTerms];
  for (int k = 0; k < kCamTerms; ++k) dcam[k] = 0.0f;
  if (i < A.n) {
    const fs_pre::Cam c = fs_pre::load_cam(A);
    fs_pre::bwd_gaussian(A, c, i, dcam);
  }
  if constexpr (CAM) {
    __shared__ float part[kCamTerms][kThreads];
    for (int k = 0; k < kCamTerms; ++k) part[k][threadIdx.x] = dcam[k];
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half)
        for (int k = 0; k < kCamTerms; ++k)
          part[k][threadIdx.x] += part[k][threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x < kCamTerms)
      cam_part[blockIdx.x * kCamTerms + threadIdx.x] = part[threadIdx.x][0];
  }
}

// One CTA per term of d viewmat sums the CTAs' rows in a fixed order;
// CTA 0 also writes the last row of the (4, 4) gradient, which is 0.
__global__ void __launch_bounds__(kReduceThreads)
    cam_reduce_kernel(const float* cam_part, int rows, float* d_viewmat) {
  const int k = blockIdx.x;
  __shared__ float acc[kReduceThreads];
  float s = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kReduceThreads)
    s += cam_part[r * kCamTerms + k];
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) acc[threadIdx.x] += acc[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    d_viewmat[fs_pre::viewmat_at(k)] = acc[0];
    if (k == 0)
      for (int j = 12; j < 16; ++j) d_viewmat[j] = 0.0f;
  }
}

}  // namespace

namespace fs_pre {

int run_fwd(const Args& A, void* stream) {
  if (A.n == 0) return 0;
  fwd_kernel<<<(A.n + kThreads - 1) / kThreads, kThreads, 0,
               (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

int run_bwd(const Args& A, float* cam_part, float* d_viewmat, void* stream) {
  const int blocks = (A.n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (cam_part == nullptr) {
    if (A.n == 0) return 0;
    bwd_kernel<false><<<blocks, kThreads, 0, s>>>(A, nullptr);
    return (int)cudaGetLastError();
  }
  if (A.n > 0) {
    bwd_kernel<true><<<blocks, kThreads, 0, s>>>(A, cam_part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cam_reduce_kernel<<<kCamTerms, kReduceThreads, 0, s>>>(cam_part, blocks,
                                                         d_viewmat);
  return (int)cudaGetLastError();
}

}  // namespace fs_pre
