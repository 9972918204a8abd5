"""SSIM (train/losses.py ssim): its routing, its wrappers' refusals
(train/ssim_kernels.py), and the kernel pair (csrc/ssim.cu) against the
plain version under autograd.
Imports no JAX, so the card's tests run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_ssim.py

The kernels' arithmetic (csrc/ssim.cuh) also compiles for the host with
g++, so the CPU tests hold it against autograd too; the gpu-marked tests
hold the kernels themselves, and skip without a card (decided inside a
fixture).

Tolerances. The kernels and the plain version compute the same float32
function with their sums in another order (the plain version's banded
matrix products, the kernels' 11-tap passes, the mean's partial sums in
double), so neither is exact: each is held against a float64 evaluation of
the same function at the same inputs (the float32 window cast up). The
kernels' gap to it may be at most GAP_FACTOR times the plain float32
version's own gap, or VALUE_ATOL on the mean SSIM and GRAD_RTOL of the
gradient's largest |value|, whichever is larger (the plain version's gap
may happen to be near zero on a small image). Two equal images give
exactly 1: the SSIM formula rounds each operation as eager PyTorch does.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fusionsense_tpu_torch.kernels import build
from fusionsense_tpu_torch.train import losses as L
from fusionsense_tpu_torch.train import ssim_kernels as SK

GAP_FACTOR = 4.0
VALUE_ATOL = 1e-6
GRAD_RTOL = 1e-6
SHAPES = [(11, 37, 1), (23, 41, 3), (480, 640, 3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def images(shape, seed=0, masked=False):
    """A render-like pair in [0, 1] as numpy arrays: a smooth texture with
    noise, and the same texture moved and noised again; masked zeroes a
    block and every fifth row of both (rgb_loss multiplies both by the
    mask)."""
    rng = np.random.default_rng(seed)
    H, W, C = shape
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, size=C)
    tex = 0.5 + 0.3 * np.sin(x[..., None] / 7.0 + phase) * np.cos(
        y[..., None] / 5.0 - phase)
    a = np.clip(tex + 0.05 * rng.normal(size=shape), 0, 1)
    b = np.clip(np.roll(tex, 1, axis=1) + 0.05 * rng.normal(size=shape), 0, 1)
    if masked:
        keep = np.ones((H, W, 1))
        keep[H // 4:H // 2, W // 3:] = 0.0
        keep[::5] = 0.0
        a, b = a * keep, b * keep
    return a.astype(np.float32), b.astype(np.float32)


def ssim64(a, b, size=11, sigma=1.5, c1=0.01 ** 2, c2=0.03 ** 2):
    """ssim_plain in float64, with its float32 window cast up."""
    k1 = torch.tensor(L._window(size, sigma), dtype=torch.float64,
                      device=a.device)
    x, y = torch.movedim(a.double(), -1, 0), torch.movedim(b.double(), -1, 0)
    f = L._filter2d_batch(torch.cat([x, y, x * x, y * y, x * y], dim=0), k1)
    C = x.shape[0]
    mu_a, mu_b = f[:C], f[C:2 * C]
    sig_a = f[2 * C:3 * C] - mu_a * mu_a
    sig_b = f[3 * C:4 * C] - mu_b * mu_b
    sig_ab = f[4 * C:] - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sig_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (sig_a + sig_b + c2))
    return torch.mean(s)


def value_and_grad(fn, a_np, b_np, device, g=1.0):
    """fn(a, b) and d (g fn) / d a, on the CPU as float64."""
    a = torch.tensor(a_np, device=device, requires_grad=True)
    b = torch.tensor(b_np, device=device)
    if fn is ssim64:
        a64 = a.detach().double().requires_grad_(True)
        v = ssim64(a64, b)
        (d,) = torch.autograd.grad(v, a64, torch.tensor(g, dtype=v.dtype,
                                                        device=device))
    else:
        v = fn(a, b)
        (d,) = torch.autograd.grad(v, a, torch.tensor(g, device=device))
    return float(v.detach()), d.detach().double().cpu()


def assert_within_plain_gap(got, plain, exact):
    """got and plain are (value, gradient) pairs of float32 versions, exact
    the float64 evaluation's."""
    v_gap, p_gap = abs(got[0] - exact[0]), abs(plain[0] - exact[0])
    assert v_gap <= max(GAP_FACTOR * p_gap, VALUE_ATOL), (v_gap, p_gap)
    scale = float(exact[1].abs().max())
    g_gap = float((got[1] - exact[1]).abs().max())
    gp_gap = float((plain[1] - exact[1]).abs().max())
    assert g_gap <= max(GAP_FACTOR * gp_gap, GRAD_RTOL * scale), (
        g_gap / scale, gp_gap / scale)


# ------------------------------------------------------- CPU: routing ----

def test_cpu_tensors_take_the_plain_version():
    a_np, b_np = images((23, 41, 3), seed=1)
    SK.reset_launch_counts()
    got = value_and_grad(L.ssim, a_np, b_np, "cpu")
    assert SK.LAUNCHES == {"ssim_fwd": 0, "ssim_bwd": 0, "ssim_plain": 1}
    want = value_and_grad(L.ssim_plain, a_np, b_np, "cpu")
    assert got[0] == want[0] and torch.equal(got[1], want[1])


def _cuda_args(shape=(16, 24, 3), **bad):
    """ssim_fwd_cuda's arguments on the CPU, with entries replaced."""
    t = {"a": torch.rand(shape), "b": torch.rand(shape)}
    t.update(bad)
    return t["a"], t["b"], (*L._window(11, 1.5), 1e-4, 9e-4)


REFUSED = {
    "cpu_tensors": {},
    "float64": {"b": torch.rand((16, 24, 3), dtype=torch.float64)},
    "not_contiguous": {"a": torch.rand((3, 24, 16)).permute(2, 1, 0)},
    "rank_2": {"a": torch.rand((16, 24)), "b": torch.rand((16, 24))},
    "h_below_11": {"a": torch.rand((10, 24, 3)), "b": torch.rand((10, 24, 3))},
    "w_below_11": {"a": torch.rand((16, 10, 3)), "b": torch.rand((16, 10, 3))},
    "shapes_differ": {"b": torch.rand((16, 25, 3))},
    "mixed_devices": {"b": torch.rand((16, 24, 3), device="meta")},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_kernel_wrappers_refuse_what_they_cannot_take(name):
    """No fallback: the CUDA wrappers raise before a launch on what the
    kernels cannot take, CPU tensors included."""
    a, b, floats = _cuda_args(**REFUSED[name])
    SK.reset_launch_counts()
    with pytest.raises(ValueError):
        SK.ssim_fwd_cuda(a, b, floats, maps=True)
    maps = torch.zeros(SK.maps_shape(*a.shape) if a.ndim == 3 else (3, 1))
    with pytest.raises(ValueError):
        SK.ssim_bwd_cuda(a, b, maps, torch.ones(()), floats)
    assert SK.LAUNCHES["ssim_fwd"] == SK.LAUNCHES["ssim_bwd"] == 0


def test_ssim_refuses_what_the_kernels_cannot_take():
    """A gradient of b (no caller asks for one), a window of another width,
    and images on two devices."""
    a = torch.rand((16, 24, 3), requires_grad=True)
    b = torch.rand((16, 24, 3), requires_grad=True)
    with pytest.raises(ValueError, match="gradient of b"):
        SK.ssim_cuda(a, b, L._window(11, 1.5), 1e-4, 9e-4)
    with pytest.raises(ValueError, match="11-tap"):
        SK.ssim_cuda(a, b.detach(), L._window(7, 1.5), 1e-4, 9e-4)
    with pytest.raises(ValueError, match="meta"):
        L.ssim(a, b.detach().to("meta"))


# ------------------------- CPU: the kernels' arithmetic, built for the host

SHIM = r"""
#include <vector>
#include "ssim.cuh"
// the header's entry points pack the arguments; here a pack runs in order
// on the host, channel by channel, as one tile the size of the image
namespace fs_ssim {
int run_fwd(const Args& A, void*) {
  const int H = A.H, W = A.W, C = A.C, Ho = out_h(A), Wo = out_w(A);
  const size_t per_map = out_n(A);
  std::vector<float> xa(H * W), xb(H * W), h((size_t)kMoments * H * Wo);
  double sum = 0.0;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < H * W; ++i) {
      xa[i] = A.a[(size_t)i * C + c];
      xb[i] = A.b[(size_t)i * C + c];
    }
    for (int r = 0; r < H; ++r)
      for (int x = 0; x < Wo; ++x) {
        float m[kMoments];
        hmoments(&xa[r * W + x], &xb[r * W + x], A.k, m);
        for (int q = 0; q < kMoments; ++q) h[((size_t)q * H + r) * Wo + x] = m[q];
      }
    for (int y = 0; y < Ho; ++y)
      for (int x = 0; x < Wo; ++x) {
        float m[kMoments], d[kMaps];
        for (int q = 0; q < kMoments; ++q)
          m[q] = tap(&h[((size_t)q * H + y) * Wo + x], Wo, A.k);
        sum += pixel(m, A.c1, A.c2, A.maps ? d : nullptr);
        if (A.maps)
          for (int q = 0; q < kMaps; ++q)
            A.maps[q * per_map + ((size_t)c * Ho + y) * Wo + x] = d[q];
      }
  }
  *A.loss = (float)(sum / (double)per_map);
  return 0;
}
int run_bwd(const Args& A, void*) {
  // the maps with 10 zero rows and columns before the first output and
  // after the last, so each input pixel's windows are all in range
  const int H = A.H, W = A.W, C = A.C, Ho = out_h(A), Wo = out_w(A);
  const int Hp = H + kHalo, Wp = W + kHalo;
  const size_t per_map = out_n(A);
  const float scale = A.g[0] / (float)per_map;
  std::vector<float> mp((size_t)kMaps * Hp * Wp), h((size_t)kMaps * Hp * W);
  for (int c = 0; c < C; ++c) {
    for (auto& v : mp) v = 0.0f;
    for (int q = 0; q < kMaps; ++q)
      for (int y = 0; y < Ho; ++y)
        for (int x = 0; x < Wo; ++x)
          mp[((size_t)q * Hp + y + kHalo) * Wp + x + kHalo] =
              A.maps[q * per_map + ((size_t)c * Ho + y) * Wo + x];
    for (int q = 0; q < kMaps; ++q)
      for (int r = 0; r < Hp; ++r)
        for (int x = 0; x < W; ++x)
          h[((size_t)q * Hp + r) * W + x] =
              tap_back(&mp[((size_t)q * Hp + r) * Wp + x + kHalo], 1, A.k);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        float f[kMaps];
        for (int q = 0; q < kMaps; ++q)
          f[q] = tap_back(&h[((size_t)q * Hp + y + kHalo) * W + x], W, A.k);
        const size_t at = ((size_t)y * W + x) * C + c;
        A.da[at] = grad(f, A.a[at], A.b[at], scale);
      }
  }
  return 0;
}
}  // namespace fs_ssim
"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """csrc/ssim.cuh built for the host by g++ (no FMA contraction): its own
    C entry points, each pack run pixel by pixel in order."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' arithmetic for the host")
    d = tmp_path_factory.mktemp("ssim_host")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(build.CSRC), "-o", str(d / "shim.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, (n_ptr, n_int, n_float) in SK._FNS.items():
        getattr(lib, fn).argtypes = ([vp] * n_ptr + [ci] * n_int
                                     + [cf] * n_float + [vp])
        getattr(lib, fn).restype = ci
    return lib


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    """SK.ssim_cuda (its Function and wrappers, every check but the one
    that CPU tensors fail) on CPU tensors with ssim's window and
    constants, launching the host build."""
    check = SK._check

    def check_on_host(*specs):
        try:
            check(*specs)
        except ValueError as e:
            if not str(e).startswith("the kernels take CUDA tensors"):
                raise

    def launch(fn, tensors, ints, floats):
        ptrs = (None if t is None else t.data_ptr() for t in tensors)
        assert getattr(host_library, fn)(*ptrs, *ints, *floats, None) == 0

    monkeypatch.setattr(SK, "_check", check_on_host)
    monkeypatch.setattr(SK, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return lambda a, b: SK.ssim_cuda(a, b, L._window(11, 1.5), 0.01 ** 2,
                                     0.03 ** 2)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_arithmetic_on_the_host_matches_autograd(host_kernels, shape,
                                                        masked):
    """The kernels' per-pixel code (csrc/ssim.cuh, built by g++) through
    ssim_cuda against the plain version under autograd, both held to
    the float64 evaluation; one forward and one backward launch."""
    a_np, b_np = images(shape, seed=sum(shape), masked=masked)
    SK.reset_launch_counts()
    got = value_and_grad(host_kernels, a_np, b_np, "cpu", g=0.7)
    assert SK.LAUNCHES == {"ssim_fwd": 1, "ssim_bwd": 1, "ssim_plain": 0}
    plain = value_and_grad(L.ssim_plain, a_np, b_np, "cpu", g=0.7)
    exact = value_and_grad(ssim64, a_np, b_np, "cpu", g=0.7)
    assert_within_plain_gap(got, plain, exact)


def test_kernel_arithmetic_on_the_host_without_grad(host_kernels):
    """Under no_grad the forward alone runs (no maps) and gives the value
    the Function gives; equal images give exactly 1."""
    a_np, b_np = images((23, 41, 3), seed=4)
    a, b = torch.tensor(a_np), torch.tensor(b_np)
    SK.reset_launch_counts()
    with torch.no_grad():
        v = host_kernels(a.requires_grad_(True), b)
        one = host_kernels(a, a.clone())
    assert SK.LAUNCHES == {"ssim_fwd": 2, "ssim_bwd": 0, "ssim_plain": 0}
    assert float(v) == float(host_kernels(a, b))
    assert float(one) == 1.0


# ------------------------------------------------------------ the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(481, 643, 3)])
def test_ssim_kernels_match_plain_on_card(card, shape, masked):
    """The kernel pair through ssim (one launch forward, one backward)
    against the plain version on the card, both held to the float64
    evaluation there; the benchmark cell's 640x480x3, odd shapes whose
    tiles are ragged, and images with zeroed regions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a_np, b_np = images(shape, seed=sum(shape), masked=masked)
    SK.reset_launch_counts()
    got = value_and_grad(L.ssim, a_np, b_np, card, g=0.7)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {"ssim_fwd": 1, "ssim_bwd": 1, "ssim_plain": 0}
    plain = value_and_grad(L.ssim_plain, a_np, b_np, card, g=0.7)
    exact = value_and_grad(ssim64, a_np, b_np, card, g=0.7)
    assert_within_plain_gap(got, plain, exact)


@pytest.mark.gpu
def test_ssim_kernels_on_equal_images_give_one_on_card(card):
    a_np, _ = images((480, 640, 3), seed=5)
    a = torch.tensor(a_np, device=card)
    assert float(L.ssim(a.clone().requires_grad_(True), a)) == 1.0
    with torch.no_grad():
        assert float(L.ssim(a, a.clone())) == 1.0


@pytest.mark.gpu
def test_ssim_kernels_are_deterministic_on_card(card):
    """The mean is a fixed-order reduction with no float atomics: two calls
    give the same loss and gradient to the bit."""
    a_np, b_np = images((480, 640, 3), seed=6)
    runs = [value_and_grad(L.ssim, a_np, b_np, card) for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
def test_ssim_kernels_replay_in_a_cuda_graph(card):
    """Captured forward and backward (the launches counted as captured)
    replay to the eager results, twice, on new inputs copied in place."""
    a_np, b_np = images((480, 640, 3), seed=7)
    a = torch.tensor(a_np, device=card, requires_grad=True)
    b = torch.tensor(b_np, device=card)

    def step():
        v = L.ssim(a, b)
        (d,) = torch.autograd.grad(v, a)
        return v, d

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                       # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    SK.CAPTURED.update(ssim_fwd=0, ssim_bwd=0)
    with torch.cuda.graph(graph):
        v_g, d_g = step()
    assert SK.CAPTURED == {"ssim_fwd": 1, "ssim_bwd": 1}
    for seed in (8, 9):
        a_np, b_np = images((480, 640, 3), seed=seed)
        with torch.no_grad():
            a.copy_(torch.tensor(a_np, device=card))
            b.copy_(torch.tensor(b_np, device=card))
        graph.replay()
        torch.cuda.synchronize()
        v_e, d_e = step()
        assert float(v_g) == float(v_e)
        assert torch.equal(d_g, d_e)


@pytest.mark.gpu
def test_ssim_kernels_on_two_streams_on_card(card):
    """The forward keeps no state between calls: calls on two streams at
    once give each stream's own result, to the bit."""
    pairs = [images((480, 640, 3), seed=s) for s in (10, 11)]
    ts = [(torch.tensor(a, device=card), torch.tensor(b, device=card))
          for a, b in pairs]
    with torch.no_grad():
        want = [L.ssim(a, b) for a, b in ts]
        streams = [torch.cuda.Stream() for _ in ts]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        got = [[], []]
        for _ in range(20):
            for i, (s, (a, b)) in enumerate(zip(streams, ts)):
                with torch.cuda.stream(s):
                    got[i].append(L.ssim(a, b))
        torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert all(torch.equal(w, v) for v in g)
