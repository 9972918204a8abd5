// SSIM's arithmetic, one pixel at a time: the 11-tap passes of the
// separable window over the five moments (a, b, a^2, b^2, ab), the SSIM
// value of an output pixel from its filtered moments with the derivatives
// the backward needs (pixel), the transposed passes and an input pixel's
// gradient (grad). ssim.cu runs these over shared-memory tiles; the
// functions also compile for the host (without nvcc, as plain C++), so the
// CPU tests can hold the kernels' arithmetic against autograd.
//
// Every step mirrors train/losses.py ssim_plain: the VALID window
// out[i] = sum_t k[t] in[i + t], the moments' products rounded before they
// are filtered, sigma = E[x y] - mu_x mu_y, and autograd's rules for the
// products and the quotient (num / den: d num = g / den, d den =
// -g (num / den) / den). The SSIM formula rounds each operation as eager
// PyTorch does (__fmul_rn / __fadd_rn / __fsub_rn are never contracted
// into an FMA), so two equal images give exactly 1 at every pixel; the
// filter sums may be contracted.
#pragma once

#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define FS_SSIM_HD __host__ __device__ __forceinline__
#else
#define FS_SSIM_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define FS_SSIM_MUL(a, b) __fmul_rn((a), (b))
#define FS_SSIM_ADD(a, b) __fadd_rn((a), (b))
#define FS_SSIM_SUB(a, b) __fsub_rn((a), (b))
#else
#define FS_SSIM_MUL(a, b) ((a) * (b))
#define FS_SSIM_ADD(a, b) ((a) + (b))
#define FS_SSIM_SUB(a, b) ((a) - (b))
#endif

namespace fs_ssim {

constexpr int kTaps = 11;            // the window's width
constexpr int kHalo = kTaps - 1;     // input pixels past an output tile
constexpr int kMoments = 5;          // mu_a, mu_b, E[a^2], E[b^2], E[ab]
constexpr int kMaps = 3;             // d s / d (mu_a, E[a^2], E[ab])

// Everything one launch reads and writes. The images are contiguous
// float32 (H, W, C); the output of the VALID window is (H - 10, W - 10)
// per channel.
struct Args {
  const float* a;      // (H, W, C) the render, which takes the gradient
  const float* b;      // (H, W, C) the target
  float* loss;         // forward: (1,) the mean SSIM
  double* part;        // forward: one partial sum per tile CTA (the card's
                       // build)
  float* maps;         // (3, C, H - 10, W - 10) d s / d (mu_a, E[a^2], E[ab])
                       // at each output pixel; forward: null writes none
  const float* g;      // backward: (1,) the cotangent of the mean
  float* da;           // backward: (H, W, C) d mean / d a, times g
  int H, W, C;
  float k[kTaps];      // the 1-D window, normalised
  float c1, c2;
};

FS_SSIM_HD int out_h(const Args& A) { return A.H - kHalo; }
FS_SSIM_HD int out_w(const Args& A) { return A.W - kHalo; }
FS_SSIM_HD size_t out_n(const Args& A) {
  return (size_t)A.C * out_h(A) * out_w(A);
}

// sum_t k[t] p[t * stride]: the VALID pass at the window's first pixel p
FS_SSIM_HD float tap(const float* p, int stride, const float* k) {
  float acc = 0.0f;
  for (int t = 0; t < kTaps; ++t) acc += k[t] * p[t * stride];
  return acc;
}

// sum_t k[t] p[-t * stride]: the transposed pass at the input pixel p, whose
// windows start at p - t (the values before the first output are 0)
FS_SSIM_HD float tap_back(const float* p, int stride, const float* k) {
  float acc = 0.0f;
  for (int t = 0; t < kTaps; ++t) acc += k[t] * p[-t * stride];
  return acc;
}

// The horizontal pass of the five moments at the window starting at pa, pb
// (unit stride).
FS_SSIM_HD void hmoments(const float* pa, const float* pb, const float* k,
                         float m[kMoments]) {
  for (int q = 0; q < kMoments; ++q) m[q] = 0.0f;
  for (int t = 0; t < kTaps; ++t) {
    const float x = pa[t], y = pb[t];
    m[0] += k[t] * x;
    m[1] += k[t] * y;
    m[2] += k[t] * FS_SSIM_MUL(x, x);
    m[3] += k[t] * FS_SSIM_MUL(y, y);
    m[4] += k[t] * FS_SSIM_MUL(x, y);
  }
}

// SSIM at an output pixel from its filtered moments m; d (when not null)
// gets d s / d (mu_a, E[a^2], E[ab]).
FS_SSIM_HD float pixel(const float m[kMoments], float c1, float c2,
                       float* d) {
  const float mu_a = m[0], mu_b = m[1];
  const float mu_aa = FS_SSIM_MUL(mu_a, mu_a);
  const float mu_bb = FS_SSIM_MUL(mu_b, mu_b);
  const float mu_ab = FS_SSIM_MUL(mu_a, mu_b);
  const float sig_a = FS_SSIM_SUB(m[2], mu_aa);
  const float sig_b = FS_SSIM_SUB(m[3], mu_bb);
  const float sig_ab = FS_SSIM_SUB(m[4], mu_ab);
  const float a1 = FS_SSIM_ADD(FS_SSIM_MUL(2.0f, mu_ab), c1);
  const float a2 = FS_SSIM_ADD(FS_SSIM_MUL(2.0f, sig_ab), c2);
  const float b1 = FS_SSIM_ADD(FS_SSIM_ADD(mu_aa, mu_bb), c1);
  const float b2 = FS_SSIM_ADD(FS_SSIM_ADD(sig_a, sig_b), c2);
  const float num = FS_SSIM_MUL(a1, a2), den = FS_SSIM_MUL(b1, b2);
  const float s = num / den;
  if (d != nullptr) {
    const float g_num = 1.0f / den;
    const float g_den = -(s / den);
    const float g_a1 = FS_SSIM_MUL(g_num, a2), g_a2 = FS_SSIM_MUL(g_num, a1);
    const float g_b1 = FS_SSIM_MUL(g_den, b2), g_b2 = FS_SSIM_MUL(g_den, b1);
    // mu_aa takes b1's gradient less sig_a's; mu_ab 2 a1's less 2 sig_ab's
    const float g_aa = FS_SSIM_SUB(g_b1, g_b2);
    const float g_ab = FS_SSIM_SUB(FS_SSIM_MUL(2.0f, g_a1),
                                   FS_SSIM_MUL(2.0f, g_a2));
    d[0] = FS_SSIM_ADD(FS_SSIM_ADD(FS_SSIM_MUL(g_aa, mu_a),
                                   FS_SSIM_MUL(g_aa, mu_a)),
                       FS_SSIM_MUL(g_ab, mu_b));
    d[1] = g_b2;
    d[2] = FS_SSIM_MUL(2.0f, g_a2);
  }
  return s;
}

// An input pixel's gradient from the transposed passes f of the three maps:
// scale (F^T d mu_a + 2 a F^T d E[a^2] + b F^T d E[ab]).
FS_SSIM_HD float grad(const float f[kMaps], float a, float b, float scale) {
  const float two_a = FS_SSIM_MUL(2.0f, a);
  return FS_SSIM_MUL(scale, FS_SSIM_ADD(FS_SSIM_ADD(f[0],
                                                    FS_SSIM_MUL(two_a, f[1])),
                                        FS_SSIM_MUL(b, f[2])));
}

// How a build runs a packed launch, defined by the file that includes this
// header: ssim.cu launches the kernels on `stream`, a host build loops over
// the pixels in order.
int run_fwd(const Args& A, void* stream);
int run_bwd(const Args& A, void* stream);

}  // namespace fs_ssim

// The C entry points, bound with ctypes: train/ssim_kernels.py _FNS gives
// their pointer, int and float counts, and kernels/build.py launch passes
// the stream last. k0..k10 are the window's taps.
#define FS_SSIM_TAPS                                                       \
  float k0, float k1, float k2, float k3, float k4, float k5, float k6,    \
      float k7, float k8, float k9, float k10

static inline void fs_ssim_pack(fs_ssim::Args& A, int H, int W, int C,
                                const float* k, float c1, float c2) {
  A.H = H; A.W = W; A.C = C; A.c1 = c1; A.c2 = c2;
  for (int t = 0; t < fs_ssim::kTaps; ++t) A.k[t] = k[t];
}

// part holds one double per tile CTA of the forward
// (train/ssim_kernels.py ssim_fwd_cuda); maps is null when no gradient is
// wanted.
extern "C" int fs_ssim_fwd(const float* a, const float* b, float* loss,
                           double* part, float* maps, int H, int W, int C,
                           FS_SSIM_TAPS, float c1, float c2, void* stream) {
  const float k[fs_ssim::kTaps] = {k0, k1, k2, k3, k4, k5, k6, k7, k8, k9,
                                   k10};
  fs_ssim::Args A = {};
  fs_ssim_pack(A, H, W, C, k, c1, c2);
  A.a = a; A.b = b; A.loss = loss; A.part = part; A.maps = maps;
  return fs_ssim::run_fwd(A, stream);
}

extern "C" int fs_ssim_bwd(const float* a, const float* b, const float* maps,
                           const float* g, float* da, int H, int W, int C,
                           FS_SSIM_TAPS, float c1, float c2, void* stream) {
  const float k[fs_ssim::kTaps] = {k0, k1, k2, k3, k4, k5, k6, k7, k8, k9,
                                   k10};
  fs_ssim::Args A = {};
  fs_ssim_pack(A, H, W, C, k, c1, c2);
  A.a = a; A.b = b; A.maps = const_cast<float*>(maps); A.g = g; A.da = da;
  return fs_ssim::run_bwd(A, stream);
}
