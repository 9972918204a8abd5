"""The rasterizer's per-Gaussian preprocess: the EWA projection, the
view-dependent SH colour and the blended channels [rgb, depth, normal] that
every backend's table reads.

`preprocess` sends CPU tensors to the plain version, the composition of
render/project.py's project_gaussians, core/sh.py's eval_sh and the
channels under autograd, and CUDA tensors to one autograd Function whose
forward is one kernel and whose backward is one kernel (csrc/preprocess.cu,
its arithmetic in csrc/preprocess.cuh); there is no fallback between the
two. The kernel pair replaces no TPU kernel: the JAX package leaves this
chain to XLA's fusion, which eager PyTorch lacks (the composition is ~340
launches forward and ~620 backward). The backward recomputes the forward
from the saved inputs. It gives the gradients of means, quats, scales,
opacities, colors, normals and mean2d_tap, and of the viewmat when that
requires grad (camera optimisation); the intrinsics take none.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.core.sh import eval_sh, num_sh_bases
from fusionsense_tpu_torch.core.transforms import normalize
from fusionsense_tpu_torch.kernels.build import Launches, check, launch
from fusionsense_tpu_torch.render.project import Projected, project_gaussians

# launch counts (kernels/build.py Launches)
_COUNTS = Launches(("preprocess_fwd", "preprocess_bwd"),
                   plain=("preprocess_plain",))
LAUNCHES, CAPTURED = _COUNTS.counts, _COUNTS.captured
reset_launch_counts, _count = _COUNTS.reset, _COUNTS.count


class Prepared(NamedTuple):
    proj: Projected              # mean2d without the tap
    mean2d: torch.Tensor         # (N, 2) screen means, tap added
    op: torch.Tensor             # (N,) opacities, AA-compensated if asked
    channels: torch.Tensor       # (N, 7) rgb, depth, normal


def preprocess_plain(means, quats, scales, opacities, colors, camera: Camera,
                     cfg, normals=None, mean2d_tap=None) -> Prepared:
    """The plain version: the composition under autograd."""
    LAUNCHES["preprocess_plain"] += 1
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
        # maximum, not clamp_min: a colour exactly at 0 (a black seed point)
        # passes half the gradient, as jnp.clip does at the tie
        rgb = eval_sh(colors, viewdir, cfg.sh_degree) + 0.5
        rgb_g = torch.maximum(rgb, torch.zeros_like(rgb))
    else:
        rgb_g = colors
    if normals is None:
        normals = _flat_normals(quats, scales, means, cam_origin)
    channels = torch.cat([rgb_g, proj.depth[:, None], normals], dim=-1)
    return Prepared(proj, mean2d, op, channels)


def _flat_normals(quats, scales, means, cam_origin):
    # imported here: render/rasterize.py imports this module
    from fusionsense_tpu_torch.render.rasterize import gaussian_flat_normals

    return gaussian_flat_normals(quats, scales, means, cam_origin)


# ----------------------------------------------------------- kernels ------

_FNS = {   # C entry point -> (pointer, int, float arguments)
    "fs_pre_fwd": (21, 6, 4), "fs_pre_bwd": (25, 6, 4),
}
_THREADS = 128            # Gaussians per CTA, as in csrc/preprocess.cu
_F32 = torch.float32


def _geometry(cfg, width: int, height: int):
    """The C entry points' (ints after n and K, floats): the image size
    and the RasterizeConfig fields the kernels read."""
    if not 0 <= cfg.sh_degree <= 3:
        raise ValueError(f"sh_degree {cfg.sh_degree}: the kernels take 0-3")
    return ((int(width), int(height), int(cfg.sh_degree),
             int(cfg.antialiased)),
            (float(cfg.near), float(cfg.far), float(cfg.eps2d),
             float(cfg.radius_clip)))


def _check(device, *specs):
    """Each spec (name, tensor, shape) must be a contiguous float32 tensor
    of that shape (None: one element) on `device`, a CUDA device."""
    check(device, *((name, t, _F32, shape) for name, t, shape in specs))


def _check_inputs(means, quats, scales, opacities, colors, cam, sh_degree):
    """(N, K): K SH coefficients per Gaussian, 0 for (N, 3) colours."""
    N = means.shape[0]
    K = colors.shape[1] if colors.ndim == 3 else 0
    if K and not num_sh_bases(sh_degree) <= K <= 16:
        raise ValueError(f"colors has {K} SH coefficients: degree "
                         f"{sh_degree} needs {num_sh_bases(sh_degree)}-16")
    viewmat, fx, fy, cx, cy = cam
    _check(means.device, ("means", means, (N, 3)), ("quats", quats, (N, 4)),
           ("scales", scales, (N, 3)), ("opacities", opacities, (N,)),
           ("colors", colors, (N, K, 3) if K else (N, 3)),
           ("viewmat", viewmat, (4, 4)), ("fx", fx, None), ("fy", fy, None),
           ("cx", cx, None), ("cy", cy, None))
    return N, K


def _launch(fn, tensors, ints, floats):
    launch("preprocess", _FNS, fn, tensors, ints, floats)


def preprocess_fwd_cuda(means, quats, scales, opacities, colors, normals, tap,
                        cam, ints, floats):
    """The forward kernel. cam is (viewmat, fx, fy, cx, cy) on the device,
    (ints, floats) is _geometry's. Returns (mean2d, mean2d + tap or None
    without a tap, depth, conic, radius, valid, compensation, op,
    channels)."""
    N, K = _check_inputs(means, quats, scales, opacities, colors, cam,
                         ints[2])
    _check(means.device, ("normals", normals, (N, 3)),
           *([("mean2d_tap", tap, (N, 2))] if tap is not None else []))
    f32 = dict(dtype=_F32, device=means.device)
    mean2d = torch.empty((N, 2), **f32)
    mean2d_t = torch.empty((N, 2), **f32) if tap is not None else None
    depth = torch.empty((N,), **f32)
    conic = torch.empty((N, 3), **f32)
    radius = torch.empty((N,), **f32)
    valid = torch.empty((N,), dtype=torch.bool, device=means.device)
    comp = torch.empty((N,), **f32)
    op = torch.empty((N,), **f32)
    chan = torch.empty((N, 7), **f32)
    _launch("fs_pre_fwd",
            (means, quats, scales, opacities, colors, normals, tap, *cam,
             mean2d, mean2d_t, depth, conic, radius, valid, comp, op, chan),
            (N, K, *ints), floats)
    _count("preprocess_fwd")
    return mean2d, mean2d_t, depth, conic, radius, valid, comp, op, chan


def preprocess_bwd_cuda(means, quats, scales, opacities, colors, cam, ints,
                        floats, cots, needs):
    """The backward kernel (and, for the viewmat's gradient, its reduction).
    cots are the cotangents of (mean2d, mean2d + tap, depth, conic,
    compensation, op, channels), None for a zero one; needs says which of
    (means, quats, scales, opacities, colors, normals, viewmat) take a
    gradient. Returns those gradients, None where not needed."""
    N, K = _check_inputs(means, quats, scales, opacities, colors, cam,
                         ints[2])
    shapes = ((N, 2), (N, 2), (N,), (N, 3), (N,), (N,), (N, 7))
    names = ("g_mean2d", "g_mean2d_t", "g_depth", "g_conic", "g_comp",
             "g_op", "g_chan")
    _check(means.device, *((n, g, s) for n, g, s in zip(names, cots, shapes)
                           if g is not None))
    f32 = dict(dtype=_F32, device=means.device)
    grads = [torch.empty(t.shape, **f32) if need else None
             for t, need in zip((means, quats, scales, opacities, colors,
                                 means), needs[:6])]
    cam_part = d_viewmat = None
    if needs[6]:
        cam_part = torch.empty((-(-N // _THREADS), 12), **f32)
        d_viewmat = torch.empty((4, 4), **f32)
    _launch("fs_pre_bwd",
            (means, quats, scales, opacities, colors, *cam, *cots, *grads,
             cam_part, d_viewmat),
            (N, K, *ints), floats)
    _count("preprocess_bwd")
    return (*grads, d_viewmat)


class _Preprocess(torch.autograd.Function):
    """Outputs (mean2d, [mean2d + tap,] depth, conic, radius, valid,
    compensation, op, channels); radius and valid take no gradient."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacities, colors, normals, tap,
                viewmat, fx, fy, cx, cy, geom):
        ctx.set_materialize_grads(False)
        ins = [t.contiguous() for t in (means, quats, scales, opacities,
                                        colors, viewmat, fx, fy, cx, cy)]
        ints, floats = geom
        outs = preprocess_fwd_cuda(
            *ins[:5], normals.contiguous(),
            None if tap is None else tap.contiguous(), ins[5:], ints, floats)
        ctx.save_for_backward(*ins)
        ctx.geom = geom
        ctx.tapped = tap is not None
        ctx.mark_non_differentiable(outs[4], outs[5])
        return tuple(o for o in outs if o is not None)

    @staticmethod
    def backward(ctx, *g):
        ins = ctx.saved_tensors
        g = list(g)
        if not ctx.tapped:
            g.insert(1, None)
        g_m, g_mt, g_depth, g_conic, _, _, g_comp, g_op, g_chan = (
            None if x is None else x.contiguous() for x in g)
        nd = ctx.needs_input_grad
        needs = (nd[0], nd[1], nd[2], nd[3], nd[4], nd[5], nd[7])
        ints, floats = ctx.geom
        d = preprocess_bwd_cuda(*ins[:5], ins[5:], ints, floats,
                                (g_m, g_mt, g_depth, g_conic, g_comp, g_op,
                                 g_chan), needs)
        d_tap = g_mt if nd[6] else None
        return (*d[:6], d_tap, d[6], None, None, None, None, None)


def preprocess(means, quats, scales, opacities, colors, camera: Camera, cfg,
               normals: Optional[torch.Tensor] = None,
               mean2d_tap: Optional[torch.Tensor] = None) -> Prepared:
    """Projection and the per-Gaussian channels for one camera, every input
    on means' device: the kernel pair for CUDA tensors, the plain version
    for CPU ones. normals None: each Gaussian's flat normal
    (render/rasterize.py gaussian_flat_normals)."""
    dev = means.device
    others = dict(quats=quats, scales=scales, opacities=opacities,
                  colors=colors, normals=normals, mean2d_tap=mean2d_tap,
                  viewmat=camera.viewmat, fx=camera.fx, fy=camera.fy,
                  cx=camera.cx, cy=camera.cy)
    for name, t in others.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, means on {dev}")
    fn = preprocess_kernels if dev.type == "cuda" else preprocess_plain
    return fn(means, quats, scales, opacities, colors, camera, cfg, normals,
              mean2d_tap)


def preprocess_kernels(means, quats, scales, opacities, colors,
                       camera: Camera, cfg, normals=None,
                       mean2d_tap=None) -> Prepared:
    """preprocess through the kernel pair (_Preprocess)."""
    if any(t.requires_grad for t in (camera.fx, camera.fy, camera.cx,
                                     camera.cy)):
        raise ValueError("the preprocess kernels give no gradient of the "
                         "intrinsics")
    if normals is None:
        normals = _flat_normals(quats, scales, means, camera.origin)
    outs = _Preprocess.apply(
        means, quats, scales, opacities, colors, normals, mean2d_tap,
        camera.viewmat, camera.fx, camera.fy, camera.cx, camera.cy,
        _geometry(cfg, camera.width, camera.height))
    if mean2d_tap is None:
        mean2d, depth, conic, radius, valid, comp, op, chan = outs
        mean2d_t = mean2d
    else:
        mean2d, mean2d_t, depth, conic, radius, valid, comp, op, chan = outs
    proj = Projected(mean2d=mean2d, depth=depth, conic=conic, radius=radius,
                     valid=valid, compensation=comp)
    return Prepared(proj, mean2d_t, op, chan)
