"""The rasterizer's per-Gaussian preprocess (render/preprocess.py): its
routing, its wrappers' refusals, the plain version as the composition the
backends used before, and the kernel pair (csrc/preprocess.cu) against the
plain version under autograd. Imports no JAX, so the card's tests run
where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_preprocess.py

The kernels' arithmetic (csrc/preprocess.cuh) also compiles for the host
with g++, so the CPU tests hold it against autograd too; the gpu-marked
tests hold the kernels themselves, and skip without a card (decided inside
a fixture).

Tolerances. The kernels and the plain version evaluate the same
expressions in another order (the plain version's matmul and norms, the
kernel's FMA contraction), so a float output or gradient differs by a few
float32 ulps of the largest term that enters it. Held column by column
against the column's largest |plain| value: FWD_REL for the forward's
floats (chains of ~50 operations: 50 ulps is 6e-6) and GRAD_REL for the
gradients (the backward's chains are twice as long and cancel in the
quaternion's and the covariance's adjoints). The crafted rows at a tie
(TIE_ROWS) are also held element by element, at EDGE_REL of the element
plus the rows' median |value|, so a tie taken the other way (a gradient
passed or stopped, or halved) shows on its own element, however small
against the array's largest; EDGE_REL leaves room for an element that
cancels (a gradient of 1.19 summed from larger terms differs by 1.4e-5 of
itself). The degenerate rows (tz ~ 0 has a 1e6 Jacobian, whose gradients
cancel to float32 noise) are held by column, and their non-finite entries
must match.
radius and valid must be equal except on a row whose pre-ceil radius lies
within TIE_REL of an integer, or whose position lies that close to a
bound of the screen test (the two sides may round across it).
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fusionsense_tpu_torch.core.cameras import make_camera
from fusionsense_tpu_torch.kernels import build
from fusionsense_tpu_torch.render import preprocess as PP
from fusionsense_tpu_torch.render import rasterize as R

FWD_REL, GRAD_REL, EDGE_REL, TIE_REL = 1e-5, 5e-5, 1e-4, 1e-5
CFG = R.RasterizeConfig(sh_degree=3, tile_capacity=256, pallas_chunk=128,
                        max_tiles_per_gaussian=16)
# the outputs the cotangents weigh: (proj.mean2d, mean2d + tap, depth,
# conic, compensation, op, channels)
OUTS = ("mean2d", "mean2d_t", "depth", "conic", "comp", "op", "chan")
INS = ("means", "quats", "scales", "opacities", "colors", "normals", "tap",
       "viewmat")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def scene(n, K=16, width=640, height=480, seed=0, dead=0.1):
    """n Gaussians around the origin seen by a rotated camera at 640x480
    (focal 550, as the benchmark's views), some of them off screen, with
    a tail of dead slots (opacity 0, the unit quaternion, the render prefix
    past the alive ones). Numpy arrays and the camera's."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    means = (rng.normal(size=(n, 3)) * 0.45).astype(f32)
    quats = rng.normal(size=(n, 4)).astype(f32)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.6 - 4.0).astype(f32)
    opac = rng.uniform(0.05, 1.0, size=n).astype(f32)
    colors = ((rng.normal(size=(n, K, 3)) * 0.3) if K else
              rng.uniform(size=(n, 3))).astype(f32)
    normals = rng.normal(size=(n, 3)).astype(f32)
    tail = int(n * dead)
    if tail:
        opac[-tail:] = 0.0
        quats[-tail:] = (1.0, 0.0, 0.0, 0.0)
    a = 0.4
    vm = np.eye(4, dtype=f32)
    vm[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    vm[:3, 3] = (0.1, -0.05, 1.6)
    cam = (vm, 550.0, 550.0, width / 2, height / 2, width, height)
    return dict(means=means, quats=quats, scales=scales, opacities=opac,
                colors=colors, normals=normals), cam


def edges(K=16):
    """Rows at the ties and guards, under the identity camera (so the
    camera-space position is the mean, exactly), at 320x240, focal 300:
    behind near, behind the camera, off screen, |tz| < 1e-6, tz = 0, x/z at
    +lim_x exactly and one float past it, y/z at -lim_y exactly, an rgb of
    exactly 0 (the higher bands 0), an rgb below 0, a zero quaternion,
    zero scales, a dead slot, and two plain rows."""
    W, H, F = 320, 240, 300.0
    fx = torch.tensor(F)
    lim_x = float(1.3 * (0.5 * W / fx))       # as project_gaussians forms it
    lim_y = float(1.3 * (0.5 * H / fx))
    past = float(np.nextafter(np.float32(lim_x), np.float32(np.inf)))
    C0 = torch.tensor(0.28209479177387814)
    c0 = torch.tensor(-0.5 / 0.28209479177387814)
    for _ in range(64):   # a c0 with C0 * c0 + 0.5 == 0 in float32
        if float(C0 * c0 + 0.5) == 0.0:
            break
        c0 = torch.nextafter(c0, torch.tensor(0.0 if float(C0 * c0 + 0.5) < 0
                                               else -1.0))
    assert float(C0 * c0 + 0.5) == 0.0
    means = [(0.1, 0.1, 0.005), (0.0, 0.0, -1.0), (5.0, 0.0, 1.0),
             (0.1, 0.1, 5e-7), (0.1, 0.1, 0.0), (lim_x, 0.1, 1.0),
             (past, 0.1, 1.0), (0.1, -lim_y, 1.0), (0.0, 0.0, 2.0),
             (0.05, 0.0, 2.0), (0.0, 0.05, 1.5), (0.02, 0.02, 1.2),
             (0.0, 0.0, 1.8), (0.1, 0.0, 1.3), (-0.1, 0.05, 2.2)]
    n = len(means)
    rng = np.random.default_rng(1)
    f32 = np.float32
    quats = rng.normal(size=(n, 4)).astype(f32)
    scales = np.full((n, 3), 0.02, f32) * rng.uniform(0.5, 2, (n, 3)).astype(f32)
    opac = np.full((n,), 0.7, f32)
    colors = ((rng.normal(size=(n, K, 3)) * 0.2) if K else
              rng.uniform(size=(n, 3))).astype(f32)
    if K:
        colors[8] = 0.0
        colors[8, 0] = float(c0)          # rgb exactly 0 in every channel
        colors[9, 0] = -5.0               # rgb below 0
    quats[10] = 0.0                       # a zero quaternion
    scales[11] = 0.0                      # zero scales
    opac[12] = 0.0                        # a dead slot
    quats[12] = (1.0, 0.0, 0.0, 0.0)
    normals = rng.normal(size=(n, 3)).astype(f32)
    cam = (np.eye(4, dtype=f32), F, F, W / 2, H / 2, W, H)
    return dict(means=np.asarray(means, f32), quats=quats, scales=scales,
                opacities=opac, colors=colors, normals=normals), cam


def tensors(arrays, cam, device, tap=True, cam_grad=False):
    """Leaves requiring grad (tap zeros, as the trainer's) and the
    camera."""
    ins = {k: torch.tensor(v, device=device).requires_grad_(True)
           for k, v in arrays.items()}
    if tap:
        ins["tap"] = torch.zeros((len(arrays["means"]), 2), device=device,
                                 requires_grad=True)
    vm, fx, fy, cx, cy, W, H = cam
    camera = make_camera(vm, fx, fy, cx, cy, W, H, device=device)
    if cam_grad:
        camera = camera.replace(
            viewmat=camera.viewmat.clone().requires_grad_(True))
    return ins, camera


def outputs(pre):
    return (pre.proj.mean2d, pre.mean2d, pre.proj.depth, pre.proj.conic,
            pre.proj.compensation, pre.op, pre.channels)


def cotangents(outs, seed, weigh=OUTS):
    """Random cotangents of the outputs (in OUTS's order) named in `weigh`,
    None elsewhere (the outputs no loss reads, as binning's detached
    reads)."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(tuple(o.shape), generator=gen).to(o.device)
            if name in weigh else None for name, o in zip(OUTS, outs)]


def forward_backward(fn, ins, camera, cfg, cots_seed=0, weigh=OUTS):
    """fn (preprocess or preprocess_plain) -> (forward outputs, radius,
    valid, gradients of the inputs named in INS, None where autograd gives
    none), every tensor on the CPU."""
    pre = fn(ins["means"], ins["quats"], ins["scales"], ins["opacities"],
             ins["colors"], camera, cfg, ins.get("normals"), ins.get("tap"))
    cots = cotangents(outputs(pre), cots_seed, weigh)
    pairs = [(o, g) for o, g in zip(outputs(pre), cots) if g is not None]
    leaves = {k: camera.viewmat if k == "viewmat" else ins.get(k)
              for k in INS}
    leaves = {k: t for k, t in leaves.items()
              if t is not None and t.requires_grad}
    grads = torch.autograd.grad([o for o, _ in pairs], list(leaves.values()),
                                [g for _, g in pairs], allow_unused=True)
    by_name = dict(zip(leaves, grads))
    cpu = lambda t: None if t is None else t.detach().cpu()  # noqa: E731
    return ({n: cpu(o) for n, o in zip(OUTS, outputs(pre))},
            cpu(pre.proj.radius), cpu(pre.proj.valid),
            {k: cpu(v) for k, v in by_name.items()})


def assert_columns_close(got, want, rel, what):
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    bad = ~torch.isfinite(want)
    assert torch.equal(bad, ~torch.isfinite(got)), f"{what}: non-finite rows"
    got, want = got.masked_fill(bad, 0.0), want.masked_fill(bad, 0.0)
    err = (got - want).abs().amax(0)
    scale = want.abs().amax(0)
    assert torch.all(err <= rel * scale + 1e-30), (
        what, (err / scale.clamp_min(1e-30)).tolist())


def assert_elements_close(got, want, rel, what):
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    bad = ~torch.isfinite(want)
    assert torch.equal(bad, ~torch.isfinite(got)), f"{what}: non-finite rows"
    got, want = got.masked_fill(bad, 0.0), want.masked_fill(bad, 0.0)
    err = (got - want).abs()
    scale = want.abs() + want.abs().median()   # the median of these rows
    assert torch.all(err <= rel * scale), (
        what, torch.nonzero(err > rel * scale).tolist())


def near_ties(fwd, radius_raw, W, H):
    """Rows whose radius or valid flag could round either way: the
    pre-ceil radius within TIE_REL of an integer, or a screen bound within
    TIE_REL of the position (both from the plain version's values)."""
    frac = radius_raw - torch.round(radius_raw)
    tie = frac.abs() <= TIE_REL * radius_raw.abs().clamp_min(1.0)
    r = torch.ceil(radius_raw)
    mx, my = fwd["mean2d"][:, 0], fwd["mean2d"][:, 1]
    for v, lo, hi in ((mx, 0.0, W), (my, 0.0, H)):
        for b in (v + r - lo, v - r - hi):
            tie |= b.abs() <= TIE_REL * v.abs().clamp_min(1.0)
    return tie


def radius_raw(arrays, cam, cfg):
    """The plain version's radius before the ceil and the culls."""
    ins, camera = tensors(arrays, cam, "cpu", tap=False)
    with torch.no_grad():
        p = PP.preprocess_plain(ins["means"], ins["quats"], ins["scales"],
                                ins["opacities"], ins["colors"], camera, cfg,
                                ins["normals"])
        ca, cb, cc = p.proj.conic.unbind(-1)
        det = ca * cc - cb * cb       # 1 / det of the 2D covariance
        a, b = cc / det, ca / det
        mid = 0.5 * (a + b)
        lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - 1.0 / det, 0.0))
        return 3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0))


# edges()'s rows at a tie: x/z at the clamp and one float past it, y/z at
# the clamp, rgb at 0 and below it (well conditioned, unlike the rows at
# tz ~ 0, whose gradients are float32 noise of a 1e6 Jacobian)
TIE_ROWS = [5, 6, 7, 8, 9]


def compare(got, want, *, edge_rows=False, ties=None):
    """Kernel side against the plain version: forward floats and
    gradients by column (the edge case's tie rows also by element), radius
    and valid equal off the ties."""
    fwd, rad, val, grads = got
    fwd_p, rad_p, val_p, grads_p = want
    for name in OUTS:
        assert_columns_close(fwd[name], fwd_p[name], FWD_REL, name)
        if edge_rows:
            assert_elements_close(fwd[name][TIE_ROWS],
                                  fwd_p[name][TIE_ROWS], EDGE_REL, name)
    keep = ~ties if ties is not None else torch.ones_like(val_p)
    assert torch.equal(val[keep], val_p[keep])
    assert torch.equal(rad[keep], rad_p[keep])
    assert set(grads) == set(grads_p)
    for k, g_p in grads_p.items():
        g = grads[k]
        if g_p is None:
            assert g is None or not g.any(), k
            continue
        assert_columns_close(g, g_p, GRAD_REL, f"d {k}")
        if edge_rows and k != "viewmat":
            assert_elements_close(g[TIE_ROWS], g_p[TIE_ROWS], EDGE_REL,
                                  f"d {k}")


# the variants each case runs in: (name, SH coefficients K, degree, AA,
# a viewmat gradient, a tap, the outputs the cotangents weigh)
CELL_WEIGH = ("mean2d_t", "conic", "op", "chan")   # what the table reads
VARIANTS = {
    "sh3": (16, 3, False, False, True, OUTS),
    "sh3_cell_cotangents": (16, 3, False, False, True, CELL_WEIGH),
    # the conic alone reaches a mean's x and y only through the clamps of
    # x/z and y/z: the clamp rows' tie is all of those elements
    "sh3_conic_cotangent": (16, 3, False, False, True, ("conic",)),
    "sh3_aa": (16, 3, True, False, True, OUTS),
    "sh3_aa_cell_cotangents": (16, 3, True, False, True, CELL_WEIGH),
    "sh3_camera_grad": (16, 3, False, True, True, OUTS),
    "sh2_of_16": (16, 2, False, False, True, OUTS),
    "sh1_of_4": (4, 1, True, True, False, OUTS),
    "sh0_of_16_no_tap": (16, 0, False, False, False, OUTS),
    "rgb": (0, 3, False, False, True, OUTS),
}


def variant(name):
    K, deg, aa, cam_grad, tap, weigh = VARIANTS[name]
    cfg = dataclasses.replace(CFG, sh_degree=deg, antialiased=aa)
    return K, cfg, cam_grad, tap, weigh


def band_masked(arrays, deg):
    """colors with the bands above `deg` zeroed, as sh_band_mask does."""
    if arrays["colors"].ndim == 3:
        arrays = dict(arrays)
        arrays["colors"] = arrays["colors"].copy()
        arrays["colors"][:, (deg + 1) ** 2:] = 0.0
    return arrays


# ------------------------------------------------------- CPU: routing ----

def test_cpu_tensors_take_the_plain_version():
    arrays, cam = scene(64)
    ins, camera = tensors(arrays, cam, "cpu")
    PP.reset_launch_counts()
    forward_backward(PP.preprocess, ins, camera, CFG)
    R.prepare(ins["means"], ins["quats"], ins["scales"], ins["opacities"],
              ins["colors"], camera, CFG, None, None)
    assert PP.LAUNCHES == {"preprocess_fwd": 0, "preprocess_bwd": 0,
                           "preprocess_plain": 2}


def _cuda_args(n=8, **bad):
    """preprocess_fwd_cuda's arguments on the CPU, with entries replaced."""
    arrays, cam = scene(n)
    t = {k: torch.tensor(v) for k, v in arrays.items()}
    t["tap"] = torch.zeros((n, 2))
    vm, fx, fy, cx, cy, W, H = cam
    t["cam"] = [torch.tensor(vm), *(torch.tensor(float(v))
                                    for v in (fx, fy, cx, cy))]
    t.update(bad)
    ints, floats = PP._geometry(CFG, W, H)
    return ((t["means"], t["quats"], t["scales"], t["opacities"], t["colors"],
             t["normals"], t["tap"], t["cam"], ints, floats))


REFUSED = {
    "cpu_tensors": {},
    "float64": {"scales": torch.ones((8, 3), dtype=torch.float64)},
    "not_contiguous": {"quats": torch.ones((4, 8)).t()},
    "wrong_shape": {"normals": torch.ones((8, 2))},
    "too_few_sh_bases": {"colors": torch.ones((8, 9, 3))},
    "too_many_sh_bases": {"colors": torch.ones((8, 25, 3))},
    "mixed_devices": {"opacities": torch.ones((8,), device="meta")},
    "two_element_fx": {"cam": [torch.eye(4), torch.ones(2), torch.ones(()),
                               torch.ones(()), torch.ones(())]},
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_kernel_wrappers_refuse_what_they_cannot_take(name):
    """No fallback: the CUDA wrappers raise before a launch on what the
    kernels cannot take, CPU tensors included."""
    args = _cuda_args(**REFUSED[name])
    PP.reset_launch_counts()
    with pytest.raises(ValueError):
        PP.preprocess_fwd_cuda(*args)
    means, quats, scales, opac, colors, _, _, cam, ints, floats = args
    cots = (None,) * 6 + (torch.zeros((8, 7)),)
    with pytest.raises(ValueError):
        PP.preprocess_bwd_cuda(means, quats, scales, opac, colors, cam, ints,
                               floats, cots, (True,) * 7)
    assert PP.LAUNCHES["preprocess_fwd"] == PP.LAUNCHES["preprocess_bwd"] == 0


def test_preprocess_refuses_mixed_devices():
    arrays, cam = scene(8)
    ins, camera = tensors(arrays, cam, "cpu")
    with pytest.raises(ValueError, match="colors"):
        PP.preprocess(ins["means"], ins["quats"], ins["scales"],
                      ins["opacities"], ins["colors"].detach().to("meta"),
                      camera, CFG, ins["normals"], ins["tap"])
    with pytest.raises(ValueError, match="sh_degree"):
        PP._geometry(dataclasses.replace(CFG, sh_degree=4), 640, 480)


# --------------------------------- CPU: the plain version, bit for bit ----

def old_prepare(means, quats, scales, opacities, colors, camera, cfg, normals,
                mean2d_tap):
    """render/rasterize.py prepare as the backends called it before the
    kernel pair: the composition this module's plain version keeps."""
    from fusionsense_tpu_torch.core.sh import eval_sh
    from fusionsense_tpu_torch.core.transforms import normalize
    from fusionsense_tpu_torch.render.project import project_gaussians

    proj = project_gaussians(means, quats, scales, opacities, camera,
                             near=cfg.near, far=cfg.far, eps2d=cfg.eps2d,
                             antialiased=cfg.antialiased,
                             radius_clip=cfg.radius_clip)
    mean2d = proj.mean2d
    if mean2d_tap is not None:
        mean2d = mean2d + mean2d_tap
    op = opacities * proj.compensation if cfg.antialiased else opacities
    cam_origin = camera.origin
    if colors.ndim == 3:
        viewdir = normalize(means - cam_origin)
        rgb = eval_sh(colors, viewdir, cfg.sh_degree) + 0.5
        rgb_g = torch.maximum(rgb, torch.zeros_like(rgb))
    else:
        rgb_g = colors
    if normals is None:
        normals = R.gaussian_flat_normals(quats, scales, means, cam_origin)
    channels = torch.cat([rgb_g, proj.depth[:, None], normals], dim=-1)
    return PP.Prepared(proj, mean2d, op, channels)


def _render_grads(backend, arrays, cam, prepare, normals):
    """rasterize with `backend` through `prepare` (patched in as
    R.preprocess), its outputs weighed by fixed random cotangents, and the
    gradients of every leaf."""
    ins, camera = tensors(arrays, cam, "cpu")
    cfg = dataclasses.replace(CFG, backend=backend)
    saved = R.preprocess
    R.preprocess = prepare
    try:
        out = R.rasterize(ins["means"], ins["quats"], ins["scales"],
                          ins["opacities"], ins["colors"], camera, cfg,
                          normals=ins["normals"] if normals else None,
                          mean2d_tap=ins["tap"], device="cpu")
    finally:
        R.preprocess = saved
    gen = torch.Generator().manual_seed(3)
    imgs = (out.rgb, out.depth, out.normal, out.alpha)
    loss = sum((x * torch.randn(x.shape, generator=gen)).sum() for x in imgs)
    leaves = [ins[k] for k in ("means", "quats", "scales", "opacities",
                               "colors", "normals", "tap")]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [x.detach() for x in imgs + (out.mean2d, out.radius)], grads


@pytest.mark.parametrize("backend", ["jax", "pallas", "flat"])
@pytest.mark.parametrize("normals", [True, False])
def test_prepare_on_the_cpu_is_the_composition_bit_for_bit(backend, normals,
                                                            one_thread):
    """Each backend's table (R.tile_table) renders and differentiates
    through R.prepare exactly as through the composition it replaced."""
    arrays, cam = scene(300, width=96, height=64, seed=2)
    cam = cam[:1] + (60.0, 60.0) + cam[3:]
    got = _render_grads(backend, arrays, cam, PP.preprocess, normals)
    want = _render_grads(backend, arrays, cam, old_prepare, normals)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for a, b in zip(got[1], want[1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_sharded_use_of_prepare_is_the_composition_bit_for_bit(one_thread):
    """parallel/sharded.py's use: R.prepare, the live set narrowed through
    proj._replace (valid and radius, as its depth slice does), then the flat
    table of a tile block (R.tile_table at tile_lo 4, 12 tiles)."""
    arrays, cam = scene(300, width=96, height=64, seed=4)
    cam = cam[:1] + (60.0, 60.0) + cam[3:]
    cfg = dataclasses.replace(CFG, backend="flat")
    tabs, grads = [], []
    for prepare in (R.prepare, old_prepare):
        ins, camera = tensors(arrays, cam, "cpu")
        pre = prepare(ins["means"], ins["quats"], ins["scales"],
                      ins["opacities"], ins["colors"], camera, cfg,
                      ins["normals"], ins["tap"])
        valid = pre.proj.valid & (pre.proj.depth > 1.5)
        pre = pre._replace(proj=pre.proj._replace(
            valid=valid, radius=torch.where(valid, pre.proj.radius,
                                            torch.zeros_like(pre.proj.radius))))
        table = R.tile_table(pre, camera, cfg, tile_lo=4,
                             num_tiles_local=12).table
        w = torch.randn(table.shape, generator=torch.Generator().manual_seed(5))
        leaves = [ins[k] for k in ("means", "quats", "scales", "opacities",
                                   "colors", "normals", "tap")]
        tabs.append(table.detach())
        grads.append(torch.autograd.grad((table * w).sum(), leaves,
                                         allow_unused=True))
    assert torch.equal(tabs[0], tabs[1])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


# blocks [tile_lo, tile_lo + 5) of a 96x64 image's 24 tiles of 16 pixels (a
# five-way tile split pads them to 25): one inside the grid, one past its end
BLOCKS = (10, 20)
T_LOC = 5


@pytest.mark.parametrize("backend", ["jax", "pallas", "flat"])
def test_tile_block_is_its_rows_of_the_whole_grid(backend, one_thread):
    """R.render_tiles over a tile block gives the whole grid's rows of its
    tiles inside the grid (the sharded step cuts the padding tile off after
    its gather), and the same gradients of cotangents on those rows, bit
    for bit: the block composites the same pairs in the same order, and a
    Gaussian's landing slots outside the block add exact zeros."""
    arrays, cam = scene(300, width=96, height=64, seed=6)
    cam = cam[:1] + (60.0, 60.0) + cam[3:]
    cfg = dataclasses.replace(CFG, backend=backend)
    names = ("means", "quats", "scales", "opacities", "colors", "normals",
             "tap")

    def render(block):
        ins, camera = tensors(arrays, cam, "cpu")
        abs_tap = (None if backend == "jax"
                   else torch.zeros((300, 2), requires_grad=True))
        pre = R.prepare(ins["means"], ins["quats"], ins["scales"],
                        ins["opacities"], ins["colors"], camera, cfg,
                        ins["normals"], ins["tap"])
        kw = {} if block is None else dict(tile_lo=block,
                                           num_tiles_local=T_LOC)
        r = R.render_tiles(pre, camera, cfg, absgrad_tap=abs_tap, **kw)
        assert int(r.bins.overflow) == 0
        return r, [ins[k] for k in names] + ([] if abs_tap is None
                                             else [abs_tap])

    whole, _ = render(None)
    T = whole.alpha.shape[0]
    assert T == 24
    for lo in BLOCKS:
        k = min(T_LOC, T - lo)
        gen = torch.Generator().manual_seed(lo)
        g_out = torch.randn((k,) + whole.out.shape[1:], generator=gen)
        g_alpha = torch.randn((k,) + whole.alpha.shape[1:], generator=gen)
        got, want = [], []
        for block, rows in ((lo, slice(0, k)), (None, slice(lo, lo + k))):
            r, leaves = render(block)
            loss = ((r.out[rows] * g_out).sum()
                    + (r.alpha[rows] * g_alpha).sum())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            got.append((r.out[rows].detach(), r.alpha[rows].detach(), grads))
            assert r.alpha.shape[0] == (T if block is None else T_LOC)
        (out_b, alpha_b, grads_b), (out_w, alpha_w, grads_w) = got
        assert torch.equal(out_b, out_w)
        assert torch.equal(alpha_b, alpha_w)
        for name, a, b in zip(names + ("absgrad_tap",), grads_b, grads_w):
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a, b), name


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------- CPU: the kernels' arithmetic, built for the host

SHIM = r"""
#include "preprocess.cuh"
// the header's entry points pack the arguments; here a pack runs in order
// on the host, d viewmat summed Gaussian by Gaussian
namespace fs_pre {
int run_fwd(const Args& A, void*) {
  const Cam c = load_cam(A);
  for (int i = 0; i < A.n; ++i) fwd_gaussian(A, c, i);
  return 0;
}
int run_bwd(const Args& A, float*, float* d_viewmat, void*) {
  const Cam c = load_cam(A);
  float sum[12] = {0.0f};
  for (int i = 0; i < A.n; ++i) {
    float dcam[12];
    bwd_gaussian(A, c, i, dcam);
    for (int k = 0; k < 12; ++k) sum[k] += dcam[k];
  }
  if (d_viewmat) {
    for (int k = 0; k < 16; ++k) d_viewmat[k] = 0.0f;
    for (int k = 0; k < 12; ++k) d_viewmat[viewmat_at(k)] = sum[k];
  }
  return 0;
}
}  // namespace fs_pre
"""


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """csrc/preprocess.cuh built for the host by g++ (no FMA contraction):
    its own C entry points, each pack run Gaussian by Gaussian in order."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' arithmetic for the host")
    d = tmp_path_factory.mktemp("preprocess_host")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(build.CSRC), "-o", str(d / "shim.so"),
                    str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, (n_ptr, n_int, n_float) in PP._FNS.items():
        getattr(lib, fn).argtypes = ([vp] * n_ptr + [ci] * n_int
                                     + [cf] * n_float + [vp])
        getattr(lib, fn).restype = ci
    return lib


@pytest.fixture
def host_kernels(host_library, monkeypatch):
    """PP.preprocess_kernels (its Function and wrappers, every check but
    the one that CPU tensors fail) on CPU tensors, launching the host
    build."""
    check = PP._check

    def check_on_host(device, *specs):
        try:
            check(device, *specs)
        except ValueError as e:
            if str(e) != f"the kernels take CUDA tensors, got {device}":
                raise

    def launch(fn, tensors, ints, floats):
        ptrs = (None if t is None else t.data_ptr() for t in tensors)
        assert getattr(host_library, fn)(*ptrs, *ints, *floats, None) == 0

    monkeypatch.setattr(PP, "_check", check_on_host)
    monkeypatch.setattr(PP, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return PP.preprocess_kernels


@pytest.mark.parametrize("case", ["scene", "edges"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernel_arithmetic_on_the_host_matches_autograd(host_kernels, case,
                                                         name):
    """The kernels' per-Gaussian code (csrc/preprocess.cuh, built by g++)
    against the plain version under autograd on the CPU, every variant on a
    random scene and on the crafted edge rows."""
    K, cfg, cam_grad, tap, weigh = variant(name)
    arrays, cam = scene(2000, K=K) if case == "scene" else edges(K=K)
    arrays = band_masked(arrays, cfg.sh_degree)
    runs = []
    for fn in (host_kernels, PP.preprocess_plain):
        ins, camera = tensors(arrays, cam, "cpu", tap=tap, cam_grad=cam_grad)
        runs.append(forward_backward(fn, ins, camera, cfg, weigh=weigh))
    ties = near_ties(runs[1][0], radius_raw(arrays, cam, cfg), *cam[5:])
    compare(*runs, edge_rows=case == "edges", ties=ties)


def jax_forward_backward(arrays, cam, cfg, tap, cam_grad, weigh):
    """The JAX package's chain on the CPU (render/project.py
    project_gaussians, core/sh.py eval_sh and the channels as its
    render/rasterize.py forms them) under jax.vjp, with forward_backward's
    cotangents; in forward_backward's form. JAX is imported here, so the
    card's tests run where it is absent."""
    import jax
    import jax.numpy as jnp

    from fusionsense_tpu.core.cameras import make_camera as make_camera_j
    from fusionsense_tpu.core.sh import eval_sh as eval_sh_j
    from fusionsense_tpu.core.transforms import normalize as normalize_j
    from fusionsense_tpu.render.project import project_gaussians as project_j

    vm, fx, fy, cx, cy, W, H = cam
    names = ("means", "quats", "scales", "opacities", "colors", "normals")
    n = len(arrays["means"])
    primals = [jnp.asarray(arrays[k]) for k in names] + [
        jnp.zeros((n, 2), jnp.float32), jnp.asarray(vm)]

    def chain(means, quats, scales, opacities, colors, normals, tap_,
              viewmat):
        camera = make_camera_j(viewmat, fx, fy, cx, cy, W, H)
        proj = project_j(means, quats, scales, opacities, camera,
                         near=cfg.near, far=cfg.far, eps2d=cfg.eps2d,
                         antialiased=cfg.antialiased,
                         radius_clip=cfg.radius_clip)
        op = opacities * (proj.compensation if cfg.antialiased else 1.0)
        if colors.ndim == 3:
            viewdir = normalize_j(means - camera.origin)
            rgb = jnp.clip(eval_sh_j(colors, viewdir, cfg.sh_degree) + 0.5,
                           0.0, None)
        else:
            rgb = colors
        chan = jnp.concatenate([rgb, proj.depth[:, None], normals], axis=-1)
        outs = (proj.mean2d, proj.mean2d + tap_, proj.depth, proj.conic,
                proj.compensation, op, chan)
        # only the weighed outputs are differentiated, as autograd skips
        # an output with no cotangent (a zero one times an infinite
        # Jacobian would be NaN)
        return (tuple(o for k, o in zip(OUTS, outs) if k in weigh),
                (outs, proj.radius, proj.valid))

    _, vjp, (outs, radius, valid) = jax.vjp(chain, *primals, has_aux=True)
    cpu = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    outs = [cpu(o) for o in outs]
    cots = cotangents(outs, 0, weigh)
    grads = vjp(tuple(jnp.asarray(g.numpy()) for g in cots if g is not None))
    leaves = list(names) + ["tap"] * tap + ["viewmat"] * cam_grad
    by_name = dict(zip(names + ("tap", "viewmat"), grads))
    return (dict(zip(OUTS, outs)), cpu(radius), cpu(valid),
            {k: cpu(by_name[k]) for k in leaves})


# Where the port's autograd, which the kernels follow, parts from the JAX
# package on edges()'s rows: x/z and y/z exactly at the clamp (rows 5, 7)
# pass the whole gradient under torch.clamp and half of it under jnp.clip;
# the culled rows at |tz| < 1e-6 (3, 4) overflow float32 in the covariance,
# so their gradients hang on each side's order of operations (JAX's
# quaternion and scale gradients there are finite, autograd's 0); a zero
# quaternion (row 10) takes a quaternion gradient of 0 under torch's norm,
# NaN under JAX's. d viewmat sums those rows too.
JAX_APART = [3, 4, 5, 7]
ZERO_QUAT = 10


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernel_arithmetic_at_the_ties_matches_jax(host_kernels, name):
    """The crafted edge rows through the kernels' per-Gaussian code
    (csrc/preprocess.cuh, built by g++) against the JAX package's chain
    under jax.vjp: the forward on every row (radius and valid equal off
    the ties), the input gradients on every row but JAX_APART's, where
    the port's autograd rule is not JAX's; one past the clamp (6), rgb
    exactly 0 with jnp.clip's half gradient (8) and rgb below 0 (9) each
    at its own scale."""
    K, cfg, cam_grad, tap, weigh = variant(name)
    arrays, cam = edges(K=K)
    arrays = band_masked(arrays, cfg.sh_degree)
    ins, camera = tensors(arrays, cam, "cpu", tap=tap, cam_grad=cam_grad)
    fwd, rad, val, grads = forward_backward(host_kernels, ins, camera, cfg,
                                            weigh=weigh)
    fwd_j, rad_j, val_j, grads_j = jax_forward_backward(
        arrays, cam, cfg, tap, cam_grad, weigh)
    ties = near_ties(fwd_j, radius_raw(arrays, cam, cfg), *cam[5:])
    compare((fwd, rad, val, {}), (fwd_j, rad_j, val_j, {}), edge_rows=True,
            ties=ties)
    assert set(grads) == set(grads_j)
    assert torch.isnan(grads_j["quats"][ZERO_QUAT]).all()
    assert not grads["quats"][ZERO_QUAT].any()
    grads_j["quats"][ZERO_QUAT] = 0.0
    rows = [i for i in range(len(val)) if i not in JAX_APART]
    tie_rows = [i for i in TIE_ROWS if i not in JAX_APART]
    for k, g_j in grads_j.items():
        if k == "viewmat":
            continue
        g = torch.zeros_like(g_j) if grads[k] is None else grads[k]
        assert_columns_close(g[rows], g_j[rows], GRAD_REL, f"d {k}")
        assert_elements_close(g[tie_rows], g_j[tie_rows], EDGE_REL, f"d {k}")


# ------------------------------------------------------------ the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("n", [24_576, 131_072])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_preprocess_kernels_match_plain_on_card(card, n, name):
    """The kernel pair through preprocess (one launch forward, one
    backward) against the plain version on the card, at the benchmark
    cell's render prefix (24,576) and at its capacity (2^17)."""
    K, cfg, cam_grad, tap, weigh = variant(name)
    arrays, cam = scene(n, K=K, seed=n)
    arrays = band_masked(arrays, cfg.sh_degree)
    PP.reset_launch_counts()
    ins, camera = tensors(arrays, cam, card, tap=tap, cam_grad=cam_grad)
    got = forward_backward(PP.preprocess, ins, camera, cfg, weigh=weigh)
    torch.cuda.synchronize()
    assert PP.LAUNCHES == {"preprocess_fwd": 1, "preprocess_bwd": 1,
                           "preprocess_plain": 0}
    ins, camera = tensors(arrays, cam, card, tap=tap, cam_grad=cam_grad)
    want = forward_backward(PP.preprocess_plain, ins, camera, cfg,
                            weigh=weigh)
    ties = near_ties(want[0], radius_raw(arrays, cam, cfg), *cam[5:])
    compare(got, want, ties=ties)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_preprocess_kernels_take_the_ties_as_autograd_on_card(card, name):
    """The crafted edge rows, each held at its own scale."""
    K, cfg, cam_grad, tap, weigh = variant(name)
    arrays, cam = edges(K=K)
    arrays = band_masked(arrays, cfg.sh_degree)
    runs = []
    for fn in (PP.preprocess, PP.preprocess_plain):
        ins, camera = tensors(arrays, cam, card, tap=tap, cam_grad=cam_grad)
        runs.append(forward_backward(fn, ins, camera, cfg, weigh=weigh))
    ties = near_ties(runs[1][0], radius_raw(arrays, cam, cfg), *cam[5:])
    compare(*runs, edge_rows=True, ties=ties)


@pytest.mark.gpu
def test_viewmat_gradient_is_deterministic_on_card(card):
    """d viewmat is a fixed-order reduction: two backward passes agree to
    the bit."""
    K, cfg, _, _, _ = variant("sh3_camera_grad")
    arrays, cam = scene(100_000, K=K, seed=9)
    got = []
    for _ in range(2):
        ins, camera = tensors(arrays, cam, card, cam_grad=True)
        got.append(forward_backward(PP.preprocess, ins, camera, cfg)[3])
    assert torch.equal(got[0]["viewmat"], got[1]["viewmat"])
    assert torch.equal(got[0]["viewmat"][3], torch.zeros(4))
