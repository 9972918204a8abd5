// The rasterizer's per-Gaussian preprocess, one Gaussian at a time: the EWA
// projection, the view-dependent SH colour and the blended channels
// (fwd_gaussian), and the adjoint of all of it (bwd_gaussian). preprocess.cu
// runs these in one thread per Gaussian; the functions also compile for the
// host (without nvcc, as plain C++), so the CPU tests can hold the kernels'
// arithmetic against autograd.
//
// Every step mirrors render/project.py project_gaussians, core/sh.py
// eval_sh and render/rasterize.py's composition, and the backward takes
// autograd's rule at each tie: torch.where(|tz| < 1e-6) passes no gradient
// to tz there; torch.clamp with tensor bounds passes it on the closed
// interval; clamp_min at x >= min; torch.maximum(rgb, 0) half of it at
// rgb == 0; sqrt's backward is g / (2 sqrt(x)) (inf or NaN at 0, as
// autograd's); a vector norm's backward is 0 at a zero norm. Constants are
// Python's doubles rounded to float32, as PyTorch rounds a scalar operand.
// The SH sum and its + 0.5 round each operation as eager PyTorch does
// (__fmul_rn / __fadd_rn / __fsub_rn are never contracted into an FMA), so
// an rgb exactly at 0 is found where the plain version finds it.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define FS_HD __host__ __device__ __forceinline__
#else
#define FS_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define FS_MUL(a, b) __fmul_rn((a), (b))
#define FS_ADD(a, b) __fadd_rn((a), (b))
#define FS_SUB(a, b) __fsub_rn((a), (b))
#else
#define FS_MUL(a, b) ((a) * (b))
#define FS_ADD(a, b) ((a) + (b))
#define FS_SUB(a, b) ((a) - (b))
#endif

namespace fs_pre {

constexpr int kChan = 7;   // rgb, depth, normal

constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
// scalars, not arrays: a namespace-scope constexpr array is not visible
// in device code
constexpr float kC20 = (float)1.0925484305920792;
constexpr float kC21 = (float)-1.0925484305920792;
constexpr float kC22 = (float)0.31539156525252005;
constexpr float kC23 = (float)-1.0925484305920792;
constexpr float kC24 = (float)0.5462742152960396;
constexpr float kC30 = (float)-0.5900435899266435;
constexpr float kC31 = (float)2.890611442640554;
constexpr float kC32 = (float)-0.4570457994644658;
constexpr float kC33 = (float)0.3731763325901154;
constexpr float kC34 = (float)-0.4570457994644658;
constexpr float kC35 = (float)1.445305721320277;
constexpr float kC36 = (float)-0.5900435899266435;

FS_HD bool is_nan(float x) { return x != x; }

// torch.clamp / clamp_min / maximum forward: NaN propagates
FS_HD float clamp_nan(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}
FS_HD float clamp_min_nan(float x, float lo) { return x < lo ? lo : x; }

// Everything one launch reads and writes. Inputs are contiguous float32
// rows; a null cotangent is a zero one (an output autograd gave no
// gradient), a null gradient output is one nobody asked for.
struct Args {
  // inputs
  const float* means;      // (N, 3)
  const float* quats;      // (N, 4) wxyz
  const float* scales;     // (N, 3)
  const float* opac;       // (N,)
  const float* colors;     // (N, K, 3) SH coefficients, or (N, 3) rgb if K == 0
  const float* normals;    // (N, 3)
  const float* tap;        // (N, 2) or null
  const float* viewmat;    // (4, 4) world to camera
  const float* fx;         // scalars on the device
  const float* fy;
  const float* cx;
  const float* cy;
  // forward outputs
  float* mean2d;           // (N, 2)
  float* mean2d_t;         // (N, 2) mean2d + tap, null without a tap
  float* depth;            // (N,)
  float* conic;            // (N, 3)
  float* radius;           // (N,)
  bool* valid;             // (N,)
  float* comp;             // (N,)
  float* op;               // (N,)
  float* chan;             // (N, 7)
  // cotangents of the forward outputs
  const float* g_mean2d;
  const float* g_mean2d_t;
  const float* g_depth;
  const float* g_conic;
  const float* g_comp;
  const float* g_op;
  const float* g_chan;
  // gradients of the inputs
  float* d_means;
  float* d_quats;
  float* d_scales;
  float* d_opac;
  float* d_colors;
  float* d_normals;
  // sizes and the RasterizeConfig fields
  int n, K, width, height, sh_degree, antialiased;
  float near_, far_, eps2d, radius_clip;
};

struct Cam {
  float R[3][3], t[3], fx, fy, cx, cy;
};

FS_HD Cam load_cam(const Args& a) {
  Cam c;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) c.R[i][j] = a.viewmat[i * 4 + j];
    c.t[i] = a.viewmat[i * 4 + 3];
  }
  c.fx = *a.fx;
  c.fy = *a.fy;
  c.cx = *a.cx;
  c.cy = *a.cy;
  return c;
}

// The forward's intermediates that the backward reads.
struct Fwd {
  float m[3], q[4], s[3];
  float p[3], tz_safe;
  float qlen, qden, qn[4];
  float G[3][3], M[3][3], s2[3];
  float c00, c01, c02, c11, c12, c22;
  float lim_x, lim_y, rx, ry, txz, tyz, inv_z, j00, j02, j11, j12;
  float v00, v11, v01, det_orig, a, b, det, det_safe, ratio, comp, inv_det;
  float mx, my, radius;
  bool valid;
  float vd[3], dlen, dden, dir[3];
};

// render/project.py project_gaussians for Gaussian i.
FS_HD void project(const Args& A, const Cam& c, int i, Fwd& f) {
  for (int k = 0; k < 3; ++k) {
    f.m[k] = A.means[3 * i + k];
    f.s[k] = A.scales[3 * i + k];
  }
  for (int k = 0; k < 4; ++k) f.q[k] = A.quats[4 * i + k];
  for (int k = 0; k < 3; ++k)
    f.p[k] = c.R[k][0] * f.m[0] + c.R[k][1] * f.m[1] + c.R[k][2] * f.m[2] +
             c.t[k];
  const float tz = f.p[2];
  f.tz_safe = fabsf(tz) < (float)1e-6 ? (float)1e-6 : tz;

  f.qlen = sqrtf(f.q[0] * f.q[0] + f.q[1] * f.q[1] + f.q[2] * f.q[2] +
                 f.q[3] * f.q[3]);
  f.qden = f.qlen + (float)1e-12;
  for (int k = 0; k < 4; ++k) f.qn[k] = f.q[k] / f.qden;
  const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
  f.G[0][0] = 1.0f - 2.0f * (y * y + z * z);
  f.G[0][1] = 2.0f * (x * y - w * z);
  f.G[0][2] = 2.0f * (x * z + w * y);
  f.G[1][0] = 2.0f * (x * y + w * z);
  f.G[1][1] = 1.0f - 2.0f * (x * x + z * z);
  f.G[1][2] = 2.0f * (y * z - w * x);
  f.G[2][0] = 2.0f * (x * z - w * y);
  f.G[2][1] = 2.0f * (y * z + w * x);
  f.G[2][2] = 1.0f - 2.0f * (x * x + y * y);
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      f.M[r][k] = c.R[r][0] * f.G[0][k] + c.R[r][1] * f.G[1][k] +
                  c.R[r][2] * f.G[2][k];
  for (int k = 0; k < 3; ++k) f.s2[k] = f.s[k] * f.s[k];
  auto cov = [&](int r, int u) {
    return f.M[r][0] * f.s2[0] * f.M[u][0] + f.M[r][1] * f.s2[1] * f.M[u][1] +
           f.M[r][2] * f.s2[2] * f.M[u][2];
  };
  f.c00 = cov(0, 0);
  f.c01 = cov(0, 1);
  f.c02 = cov(0, 2);
  f.c11 = cov(1, 1);
  f.c12 = cov(1, 2);
  f.c22 = cov(2, 2);

  // 1.3 * (0.5 * W / fx): Python's scalar / tensor is reciprocal * scalar
  f.lim_x = (float)1.3 * ((1.0f / c.fx) * (float)(0.5 * A.width));
  f.lim_y = (float)1.3 * ((1.0f / c.fy) * (float)(0.5 * A.height));
  f.rx = f.p[0] / f.tz_safe;
  f.ry = f.p[1] / f.tz_safe;
  f.txz = clamp_nan(f.rx, -f.lim_x, f.lim_x);
  f.tyz = clamp_nan(f.ry, -f.lim_y, f.lim_y);
  f.inv_z = 1.0f / f.tz_safe;
  f.j00 = c.fx * f.inv_z;
  f.j02 = -c.fx * f.txz * f.inv_z;
  f.j11 = c.fy * f.inv_z;
  f.j12 = -c.fy * f.tyz * f.inv_z;

  f.v00 = f.j00 * f.j00 * f.c00 + 2.0f * f.j00 * f.j02 * f.c02 +
          f.j02 * f.j02 * f.c22;
  f.v11 = f.j11 * f.j11 * f.c11 + 2.0f * f.j11 * f.j12 * f.c12 +
          f.j12 * f.j12 * f.c22;
  f.v01 = f.j00 * f.j11 * f.c01 + f.j00 * f.j12 * f.c02 +
          f.j02 * f.j11 * f.c12 + f.j02 * f.j12 * f.c22;
  f.det_orig = f.v00 * f.v11 - f.v01 * f.v01;
  f.a = f.v00 + A.eps2d;
  f.b = f.v11 + A.eps2d;
  f.det = f.a * f.b - f.v01 * f.v01;
  f.det_safe = clamp_min_nan(f.det, (float)1e-10);
  f.ratio = f.det_orig / f.det_safe;
  f.comp = sqrtf(clamp_min_nan(f.ratio, 0.0f));
  f.inv_det = 1.0f / f.det_safe;

  f.mx = c.fx * f.p[0] * f.inv_z + c.cx;
  f.my = c.fy * f.p[1] * f.inv_z + c.cy;
  const float mid = 0.5f * (f.a + f.b);
  const float lam1 = mid + sqrtf(clamp_min_nan(mid * mid - f.det, 0.0f));
  float radius = ceilf(3.0f * sqrtf(clamp_min_nan(lam1, 0.0f)));
  const float W = (float)A.width, H = (float)A.height;
  f.valid = tz > A.near_ && tz < A.far_ && f.det > 0.0f &&
            radius > A.radius_clip && f.mx + radius > 0.0f &&
            f.mx - radius < W && f.my + radius > 0.0f && f.my - radius < H;
  f.radius = f.valid ? radius : 0.0f;

  // viewdir = normalize(means - origin), origin = -R^T t
  for (int k = 0; k < 3; ++k) {
    const float o = -(c.R[0][k] * c.t[0] + c.R[1][k] * c.t[1] +
                      c.R[2][k] * c.t[2]);
    f.vd[k] = f.m[k] - o;
  }
  f.dlen = sqrtf(f.vd[0] * f.vd[0] + f.vd[1] * f.vd[1] + f.vd[2] * f.vd[2]);
  f.dden = f.dlen + (float)1e-12;
  for (int k = 0; k < 3; ++k) f.dir[k] = f.vd[k] / f.dden;
}

// core/sh.py eval_sh for channel ch of one Gaussian's (K, 3) coefficients,
// operation for operation as eager PyTorch rounds it.
FS_HD float sh_eval(const float* co, int ch, int deg, const float dir[3]) {
  const float x = dir[0], y = dir[1], z = dir[2];
#define FS_CO(k) co[(k) * 3 + ch]
  float r = FS_MUL(kC0, FS_CO(0));
  if (deg >= 1) {
    r = FS_SUB(r, FS_MUL(FS_MUL(kC1, y), FS_CO(1)));
    r = FS_ADD(r, FS_MUL(FS_MUL(kC1, z), FS_CO(2)));
    r = FS_SUB(r, FS_MUL(FS_MUL(kC1, x), FS_CO(3)));
  }
  if (deg >= 2) {
    const float xx = FS_MUL(x, x), yy = FS_MUL(y, y), zz = FS_MUL(z, z);
    const float xy = FS_MUL(x, y), yz = FS_MUL(y, z), xz = FS_MUL(x, z);
    r = FS_ADD(r, FS_MUL(FS_MUL(kC20, xy), FS_CO(4)));
    r = FS_ADD(r, FS_MUL(FS_MUL(kC21, yz), FS_CO(5)));
    r = FS_ADD(r, FS_MUL(FS_MUL(kC22, FS_SUB(FS_SUB(FS_MUL(2.0f, zz), xx),
                                                yy)),
                         FS_CO(6)));
    r = FS_ADD(r, FS_MUL(FS_MUL(kC23, xz), FS_CO(7)));
    r = FS_ADD(r, FS_MUL(FS_MUL(kC24, FS_SUB(xx, yy)), FS_CO(8)));
    if (deg >= 3) {
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC30, y),
                                  FS_SUB(FS_MUL(3.0f, xx), yy)),
                           FS_CO(9)));
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC31, xy), z), FS_CO(10)));
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC32, y),
                                  FS_SUB(FS_SUB(FS_MUL(4.0f, zz), xx), yy)),
                           FS_CO(11)));
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC33, z),
                                  FS_SUB(FS_SUB(FS_MUL(2.0f, zz),
                                                FS_MUL(3.0f, xx)),
                                         FS_MUL(3.0f, yy))),
                           FS_CO(12)));
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC34, x),
                                  FS_SUB(FS_SUB(FS_MUL(4.0f, zz), xx), yy)),
                           FS_CO(13)));
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC35, z), FS_SUB(xx, yy)),
                           FS_CO(14)));
      r = FS_ADD(r, FS_MUL(FS_MUL(FS_MUL(kC36, x),
                                  FS_SUB(xx, FS_MUL(3.0f, yy))),
                           FS_CO(15)));
    }
  }
#undef FS_CO
  return r;
}

// The SH bases of one direction (bases[k] multiplies coefficient k; the
// signs of bands 1 and 3 included) and their gradients in the direction.
FS_HD void sh_bases(int deg, const float dir[3], float b[16], float db[16][3]) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  for (int k = 0; k < 16; ++k) {
    b[k] = 0.0f;
    db[k][0] = db[k][1] = db[k][2] = 0.0f;
  }
  b[0] = kC0;
  if (deg >= 1) {
    b[1] = -kC1 * y;  db[1][1] = -kC1;
    b[2] = kC1 * z;   db[2][2] = kC1;
    b[3] = -kC1 * x;  db[3][0] = -kC1;
  }
  if (deg >= 2) {
    b[4] = kC20 * xy;
    db[4][0] = kC20 * y;  db[4][1] = kC20 * x;
    b[5] = kC21 * yz;
    db[5][1] = kC21 * z;  db[5][2] = kC21 * y;
    b[6] = kC22 * (2.0f * zz - xx - yy);
    db[6][0] = kC22 * (-2.0f * x);
    db[6][1] = kC22 * (-2.0f * y);
    db[6][2] = kC22 * (4.0f * z);
    b[7] = kC23 * xz;
    db[7][0] = kC23 * z;  db[7][2] = kC23 * x;
    b[8] = kC24 * (xx - yy);
    db[8][0] = kC24 * (2.0f * x);
    db[8][1] = kC24 * (-2.0f * y);
  }
  if (deg >= 3) {
    b[9] = kC30 * y * (3.0f * xx - yy);
    db[9][0] = kC30 * 6.0f * xy;
    db[9][1] = kC30 * (3.0f * xx - 3.0f * yy);
    b[10] = kC31 * xy * z;
    db[10][0] = kC31 * yz;
    db[10][1] = kC31 * xz;
    db[10][2] = kC31 * xy;
    b[11] = kC32 * y * (4.0f * zz - xx - yy);
    db[11][0] = kC32 * (-2.0f * xy);
    db[11][1] = kC32 * (4.0f * zz - xx - 3.0f * yy);
    db[11][2] = kC32 * 8.0f * yz;
    b[12] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    db[12][0] = kC33 * (-6.0f * xz);
    db[12][1] = kC33 * (-6.0f * yz);
    db[12][2] = kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
    b[13] = kC34 * x * (4.0f * zz - xx - yy);
    db[13][0] = kC34 * (4.0f * zz - 3.0f * xx - yy);
    db[13][1] = kC34 * (-2.0f * xy);
    db[13][2] = kC34 * 8.0f * xz;
    b[14] = kC35 * z * (xx - yy);
    db[14][0] = kC35 * 2.0f * xz;
    db[14][1] = kC35 * (-2.0f * yz);
    db[14][2] = kC35 * (xx - yy);
    b[15] = kC36 * x * (xx - 3.0f * yy);
    db[15][0] = kC36 * (3.0f * xx - 3.0f * yy);
    db[15][1] = kC36 * (-6.0f * xy);
  }
}

// rgb = eval_sh(...) + 0.5 before the clamp at 0, or the (N, 3) colour.
FS_HD void rgb_of(const Args& A, const Fwd& f, int i, float rgb[3]) {
  if (A.K == 0) {
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = A.colors[3 * i + ch];
    return;
  }
  const float* co = A.colors + (size_t)i * A.K * 3;
  for (int ch = 0; ch < 3; ++ch)
    rgb[ch] = FS_ADD(sh_eval(co, ch, A.sh_degree, f.dir), 0.5f);
}

// Everything _prepare returns, for Gaussian i.
FS_HD void fwd_gaussian(const Args& A, const Cam& c, int i) {
  Fwd f;
  project(A, c, i, f);
  A.mean2d[2 * i] = f.mx;
  A.mean2d[2 * i + 1] = f.my;
  if (A.mean2d_t) {
    A.mean2d_t[2 * i] = f.mx + A.tap[2 * i];
    A.mean2d_t[2 * i + 1] = f.my + A.tap[2 * i + 1];
  }
  A.depth[i] = f.p[2];
  A.conic[3 * i] = f.b * f.inv_det;
  A.conic[3 * i + 1] = -f.v01 * f.inv_det;
  A.conic[3 * i + 2] = f.a * f.inv_det;
  A.radius[i] = f.radius;
  A.valid[i] = f.valid;
  A.comp[i] = f.comp;
  A.op[i] = A.antialiased ? A.opac[i] * f.comp : A.opac[i];
  float rgb[3];
  rgb_of(A, f, i, rgb);
  float* ch = A.chan + (size_t)i * kChan;
  for (int k = 0; k < 3; ++k)
    ch[k] = (A.K == 0 || is_nan(rgb[k])) ? rgb[k] : fmaxf(rgb[k], 0.0f);
  ch[3] = f.p[2];
  for (int k = 0; k < 3; ++k) ch[4 + k] = A.normals[3 * i + k];
}

FS_HD float cot(const float* g, size_t at) { return g ? g[at] : 0.0f; }

// d (v / (|v| + 1e-12)) for a cotangent g of the normalized v: torch's
// division and vector-norm backward (the norm's term is 0 at |v| = 0).
FS_HD void normalize_bwd(const float* v, float len, float den, const float* u,
                         const float* g, int n, float* dv) {
  float dot = 0.0f;
  for (int k = 0; k < n; ++k) dot += g[k] * u[k];
  const float dden = -dot / den;
  for (int k = 0; k < n; ++k)
    dv[k] = g[k] / den + (len == 0.0f ? 0.0f : dden * v[k] / len);
}

// The gradients of Gaussian i's inputs from the cotangents of its outputs;
// dcam (dR row-major, then dt) receives its share of d viewmat.
FS_HD void bwd_gaussian(const Args& A, const Cam& c, int i, float dcam[12]) {
  Fwd f;
  project(A, c, i, f);
  const float opac = A.opac[i];

  // cotangents
  const float gmx = cot(A.g_mean2d, 2 * i) + cot(A.g_mean2d_t, 2 * i);
  const float gmy = cot(A.g_mean2d, 2 * i + 1) + cot(A.g_mean2d_t, 2 * i + 1);
  const float gca = cot(A.g_conic, 3 * i), gcb = cot(A.g_conic, 3 * i + 1),
              gcc = cot(A.g_conic, 3 * i + 2);
  const float gop = cot(A.g_op, i);
  const bool comp_used = A.g_comp || (A.antialiased && A.g_op);
  const float gcomp = cot(A.g_comp, i) + (A.antialiased ? gop * opac : 0.0f);
  float gtz = cot(A.g_depth, i) + cot(A.g_chan, (size_t)i * kChan + 3);

  float dm[3] = {0.0f, 0.0f, 0.0f}, dR[3][3] = {}, dt[3] = {0.0f, 0.0f, 0.0f};

  // channels: colour and normal
  float g_rgb[3];
  for (int k = 0; k < 3; ++k) g_rgb[k] = cot(A.g_chan, (size_t)i * kChan + k);
  if (A.d_normals)
    for (int k = 0; k < 3; ++k)
      A.d_normals[3 * i + k] = cot(A.g_chan, (size_t)i * kChan + 4 + k);
  if (A.K == 0) {
    if (A.d_colors)
      for (int k = 0; k < 3; ++k) A.d_colors[3 * i + k] = g_rgb[k];
  } else {
    float rgb[3];
    rgb_of(A, f, i, rgb);
    for (int k = 0; k < 3; ++k) {   // torch.maximum(rgb, 0)'s backward
      if (rgb[k] == 0.0f) g_rgb[k] = g_rgb[k] / 2.0f;
      else if (rgb[k] < 0.0f) g_rgb[k] = 0.0f;
    }
    float b[16], db[16][3];
    sh_bases(A.sh_degree, f.dir, b, db);
    const int nb = (A.sh_degree + 1) * (A.sh_degree + 1);
    const float* co = A.colors + (size_t)i * A.K * 3;
    float gdir[3] = {0.0f, 0.0f, 0.0f};
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int k = 0; k < 16; ++k) {   // K <= 16: the wrapper refuses more
      if (k >= A.K) break;
      const bool used = k < nb;
      float s = 0.0f;
      for (int ch = 0; ch < 3; ++ch) {
        if (A.d_colors)
          A.d_colors[((size_t)i * A.K + k) * 3 + ch] =
              used ? g_rgb[ch] * b[k] : 0.0f;
        if (used) s += g_rgb[ch] * co[k * 3 + ch];
      }
      if (used && k > 0)
        for (int a = 0; a < 3; ++a) gdir[a] += s * db[k][a];
    }
    float dvd[3];
    normalize_bwd(f.vd, f.dlen, f.dden, f.dir, gdir, 3, dvd);
    // vd = m - origin, origin = -R^T t
    for (int k = 0; k < 3; ++k) {
      dm[k] += dvd[k];
      for (int j = 0; j < 3; ++j) {
        dR[j][k] += dvd[k] * c.t[j];
        dt[j] += c.R[j][k] * dvd[k];
      }
    }
  }

  // opacity
  if (A.d_opac) A.d_opac[i] = A.antialiased ? gop * f.comp : gop;

  // mean2d = (fx px inv_z + cx, fy py inv_z + cy)
  float dp[3] = {gmx * f.inv_z * c.fx, gmy * f.inv_z * c.fy, 0.0f};
  float dinv_z = gmx * (c.fx * f.p[0]) + gmy * (c.fy * f.p[1]);

  // conic = (b, -v01, a) / det_safe
  float da = gcc * f.inv_det, db_ = gca * f.inv_det, dv01 = -gcb * f.inv_det;
  const float dinv_det = gca * f.b - gcb * f.v01 + gcc * f.a;
  float ddet_safe = -dinv_det * f.inv_det * f.inv_det;
  float ddet_orig = 0.0f;
  if (comp_used) {   // comp = sqrt(clamp_min(det_orig / det_safe, 0))
    const float dcm = gcomp / (2.0f * f.comp);
    const float dratio = f.ratio >= 0.0f ? dcm : 0.0f;
    ddet_orig = dratio / f.det_safe;
    ddet_safe += -dratio * (f.ratio / f.det_safe);
  }
  const float ddet = f.det >= (float)1e-10 ? ddet_safe : 0.0f;
  da += ddet * f.b;
  db_ += ddet * f.a;
  dv01 += -2.0f * f.v01 * (ddet + ddet_orig);
  const float dv00 = ddet_orig * f.v11 + da;
  const float dv11 = ddet_orig * f.v00 + db_;

  // v = J cov J^T
  const float dj00 = dv00 * (2.0f * f.j00 * f.c00 + 2.0f * f.j02 * f.c02) +
                     dv01 * (f.j11 * f.c01 + f.j12 * f.c02);
  const float dj02 = dv00 * (2.0f * f.j00 * f.c02 + 2.0f * f.j02 * f.c22) +
                     dv01 * (f.j11 * f.c12 + f.j12 * f.c22);
  const float dj11 = dv11 * (2.0f * f.j11 * f.c11 + 2.0f * f.j12 * f.c12) +
                     dv01 * (f.j00 * f.c01 + f.j02 * f.c12);
  const float dj12 = dv11 * (2.0f * f.j11 * f.c12 + 2.0f * f.j12 * f.c22) +
                     dv01 * (f.j00 * f.c02 + f.j02 * f.c22);
  const float dc00 = dv00 * f.j00 * f.j00;
  const float dc11 = dv11 * f.j11 * f.j11;
  const float dc01 = dv01 * f.j00 * f.j11;
  const float dc02 = dv00 * 2.0f * f.j00 * f.j02 + dv01 * f.j00 * f.j12;
  const float dc12 = dv11 * 2.0f * f.j11 * f.j12 + dv01 * f.j02 * f.j11;
  const float dc22 = dv00 * f.j02 * f.j02 + dv11 * f.j12 * f.j12 +
                     dv01 * f.j02 * f.j12;

  // the Jacobian's entries
  dinv_z += dj00 * c.fx + dj02 * (-c.fx * f.txz) + dj11 * c.fy +
            dj12 * (-c.fy * f.tyz);
  const float dtxz = dj02 * (-c.fx) * f.inv_z;
  const float dtyz = dj12 * (-c.fy) * f.inv_z;
  const float drx = (f.rx >= -f.lim_x && f.rx <= f.lim_x) ? dtxz : 0.0f;
  const float dry = (f.ry >= -f.lim_y && f.ry <= f.lim_y) ? dtyz : 0.0f;
  dp[0] += drx / f.tz_safe;
  dp[1] += dry / f.tz_safe;
  float dtz_safe = -drx * (f.rx / f.tz_safe) - dry * (f.ry / f.tz_safe);
  dtz_safe += -dinv_z * f.inv_z * f.inv_z;
  gtz += fabsf(f.p[2]) < (float)1e-6 ? 0.0f : dtz_safe;
  dp[2] += gtz;

  // p = R m + t
  for (int k = 0; k < 3; ++k) {
    dt[k] += dp[k];
    for (int j = 0; j < 3; ++j) {
      dm[j] += c.R[k][j] * dp[k];
      dR[k][j] += dp[k] * f.m[j];
    }
  }

  // cov = M diag(s^2) M^T, from the six entries' cotangents
  const float E[3][3] = {{2.0f * dc00, dc01, dc02},
                         {dc01, 2.0f * dc11, dc12},
                         {dc02, dc12, 2.0f * dc22}};
  float dM[3][3];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      dM[r][k] = f.s2[k] * (E[r][0] * f.M[0][k] + E[r][1] * f.M[1][k] +
                            E[r][2] * f.M[2][k]);
  if (A.d_scales)
    for (int k = 0; k < 3; ++k) {
      const float ds2 = dc00 * f.M[0][k] * f.M[0][k] +
                        dc11 * f.M[1][k] * f.M[1][k] +
                        dc22 * f.M[2][k] * f.M[2][k] +
                        dc01 * f.M[0][k] * f.M[1][k] +
                        dc02 * f.M[0][k] * f.M[2][k] +
                        dc12 * f.M[1][k] * f.M[2][k];
      A.d_scales[3 * i + k] = 2.0f * f.s[k] * ds2;
    }

  // M = R G
  float dG[3][3];
  for (int j = 0; j < 3; ++j)
    for (int k = 0; k < 3; ++k) {
      dG[j][k] = c.R[0][j] * dM[0][k] + c.R[1][j] * dM[1][k] +
                 c.R[2][j] * dM[2][k];
    }
  for (int r = 0; r < 3; ++r)
    for (int j = 0; j < 3; ++j)
      dR[r][j] += dM[r][0] * f.G[j][0] + dM[r][1] * f.G[j][1] +
                  dM[r][2] * f.G[j][2];

  // G of the normalized quaternion
  if (A.d_quats) {
    const float w = f.qn[0], x = f.qn[1], y = f.qn[2], z = f.qn[3];
    float dqn[4];
    dqn[0] = 2.0f * (-z * dG[0][1] + y * dG[0][2] + z * dG[1][0] -
                     x * dG[1][2] - y * dG[2][0] + x * dG[2][1]);
    dqn[1] = 2.0f * (y * dG[0][1] + z * dG[0][2] + y * dG[1][0] -
                     2.0f * x * dG[1][1] - w * dG[1][2] + z * dG[2][0] +
                     w * dG[2][1] - 2.0f * x * dG[2][2]);
    dqn[2] = 2.0f * (-2.0f * y * dG[0][0] + x * dG[0][1] + w * dG[0][2] +
                     x * dG[1][0] + z * dG[1][2] - w * dG[2][0] +
                     z * dG[2][1] - 2.0f * y * dG[2][2]);
    dqn[3] = 2.0f * (-2.0f * z * dG[0][0] - w * dG[0][1] + x * dG[0][2] +
                     w * dG[1][0] - 2.0f * z * dG[1][1] + y * dG[1][2] +
                     x * dG[2][0] + y * dG[2][1]);
    float dq[4];
    normalize_bwd(f.q, f.qlen, f.qden, f.qn, dqn, 4, dq);
    for (int k = 0; k < 4; ++k) A.d_quats[4 * i + k] = dq[k];
  }
  if (A.d_means)
    for (int k = 0; k < 3; ++k) A.d_means[3 * i + k] = dm[k];
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) dcam[3 * r + j] = dR[r][j];
    dcam[9 + r] = dt[r];
  }
}

// The entry of the (4, 4) d viewmat that bwd_gaussian's dcam[k] sums into:
// dR row-major, then dt in the last column; the last row takes nothing.
FS_HD int viewmat_at(int k) { return k < 9 ? (k / 3) * 4 + k % 3 : (k - 9) * 4 + 3; }

// How a build runs a packed launch, defined by the file that includes this
// header: preprocess.cu launches the kernels on `stream`, a host build
// loops over the Gaussians in order. run_bwd gets cam_part and d_viewmat
// both null or both given (d viewmat wanted).
int run_fwd(const Args& A, void* stream);
int run_bwd(const Args& A, float* cam_part, float* d_viewmat, void* stream);

}  // namespace fs_pre

// The C entry points, bound with ctypes: render/preprocess.py _FNS gives
// their pointer, int and float counts, and kernels/build.py launch passes
// the stream last. They pack their arguments into Args here, once, for
// every build of this header.
extern "C" int fs_pre_fwd(
    const float* means, const float* quats, const float* scales,
    const float* opac, const float* colors, const float* normals,
    const float* tap, const float* viewmat, const float* fx, const float* fy,
    const float* cx, const float* cy, float* mean2d, float* mean2d_t,
    float* depth, float* conic, float* radius, bool* valid, float* comp,
    float* op, float* chan, int n, int K, int width, int height,
    int sh_degree, int antialiased, float near_, float far_, float eps2d,
    float radius_clip, void* stream) {
  fs_pre::Args A = {};
  A.n = n; A.K = K; A.width = width; A.height = height;
  A.sh_degree = sh_degree; A.antialiased = antialiased;
  A.near_ = near_; A.far_ = far_; A.eps2d = eps2d; A.radius_clip = radius_clip;
  A.means = means; A.quats = quats; A.scales = scales; A.opac = opac;
  A.colors = colors; A.normals = normals; A.tap = tap; A.viewmat = viewmat;
  A.fx = fx; A.fy = fy; A.cx = cx; A.cy = cy;
  A.mean2d = mean2d; A.mean2d_t = mean2d_t; A.depth = depth;
  A.conic = conic; A.radius = radius; A.valid = valid; A.comp = comp;
  A.op = op; A.chan = chan;
  return fs_pre::run_fwd(A, stream);
}

// cam_part ((n + 127) / 128, 12) and d_viewmat (4, 4) are both null or
// both given.
extern "C" int fs_pre_bwd(
    const float* means, const float* quats, const float* scales,
    const float* opac, const float* colors, const float* viewmat,
    const float* fx, const float* fy, const float* cx, const float* cy,
    const float* g_mean2d, const float* g_mean2d_t, const float* g_depth,
    const float* g_conic, const float* g_comp, const float* g_op,
    const float* g_chan, float* d_means, float* d_quats, float* d_scales,
    float* d_opac, float* d_colors, float* d_normals, float* cam_part,
    float* d_viewmat, int n, int K, int width, int height, int sh_degree,
    int antialiased, float near_, float far_, float eps2d, float radius_clip,
    void* stream) {
  fs_pre::Args A = {};
  A.n = n; A.K = K; A.width = width; A.height = height;
  A.sh_degree = sh_degree; A.antialiased = antialiased;
  A.near_ = near_; A.far_ = far_; A.eps2d = eps2d; A.radius_clip = radius_clip;
  A.means = means; A.quats = quats; A.scales = scales; A.opac = opac;
  A.colors = colors; A.viewmat = viewmat;
  A.fx = fx; A.fy = fy; A.cx = cx; A.cy = cy;
  A.g_mean2d = g_mean2d; A.g_mean2d_t = g_mean2d_t; A.g_depth = g_depth;
  A.g_conic = g_conic; A.g_comp = g_comp; A.g_op = g_op; A.g_chan = g_chan;
  A.d_means = d_means; A.d_quats = d_quats; A.d_scales = d_scales;
  A.d_opac = d_opac; A.d_colors = d_colors; A.d_normals = d_normals;
  return fs_pre::run_bwd(A, cam_part, d_viewmat, stream);
}
