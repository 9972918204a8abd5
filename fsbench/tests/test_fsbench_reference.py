"""The plain reference against small hand-computed cases."""
import math

import pytest
import torch

from fsbench.reference import losses as RL
from fsbench.reference import refine as RF
from fsbench.reference import render as RR
from fsbench.reference import step as RS
from fsbench.scene import rotation_between

RASTER = dict(tile_size=16, eps2d=0.3, near=0.01, far=1e10,
              max_tiles_per_gaussian=16)


def cam(W=32, H=32, f=50.0):
    return dict(viewmat=torch.eye(4), fx=torch.tensor(f), fy=torch.tensor(f),
                cx=torch.tensor(W / 2), cy=torch.tensor(H / 2), width=W,
                height=H)


def gaussians(means, scale=0.01, opacity=0.5, rgb=0.8):
    n = len(means)
    z = torch.zeros((n, 3))
    return dict(means=torch.tensor(means, dtype=torch.float32),
                quats=torch.tensor([[1.0, 0, 0, 0]] * n),
                log_scales=torch.full((n, 3), math.log(scale)),
                logit_opacities=torch.full((n,), math.log(opacity / (1 - opacity))),
                features_dc=torch.full((n, 3), (rgb - 0.5) / RR.SH_C0),
                features_rest=torch.zeros((n, 15, 3)), normals=z)


def test_one_gaussian_at_a_pixel_centre():
    """A Gaussian at depth 2 over pixel (16, 16)'s centre: that pixel's
    alpha is its opacity, its colour rgb * alpha, its depth 2."""
    c = cam()
    g = gaussians([[0.5 / 50 * 2, 0.5 / 50 * 2, 2.0]])
    out = RR.render(g, c, RASTER, 0)
    assert out["alpha"][16, 16].item() == pytest.approx(0.5, rel=1e-5)
    assert out["rgb"][16, 16, 0].item() == pytest.approx(0.4, rel=1e-5)
    assert out["depth"][16, 16].item() == pytest.approx(2.0, rel=1e-5)
    # sigma on screen: 0.01 * 50 / 2 = 0.25 px, with the 0.3 px^2 low-pass
    var = 0.25 ** 2 + 0.3
    a1 = 0.5 * math.exp(-0.5 / var)
    assert out["alpha"][16, 17].item() == pytest.approx(a1, rel=1e-4)


def test_two_gaussians_composite_front_to_back():
    """Behind one of opacity 0.5, a second of opacity 0.5 adds 0.5 * 0.5."""
    c = cam()
    x = 0.5 / 50
    g = gaussians([[x * 3, x * 3, 3.0], [x * 2, x * 2, 2.0]])
    g["features_dc"][0] = (0.2 - 0.5) / RR.SH_C0
    out = RR.render(g, c, RASTER, 0, count=True)
    assert out["alpha"][16, 16].item() == pytest.approx(0.75, rel=1e-5)
    assert out["rgb"][16, 16, 0].item() == pytest.approx(
        0.5 * 0.8 + 0.25 * 0.2, rel=1e-5)
    assert out["depth"][16, 16].item() == pytest.approx(
        (0.5 * 2 + 0.25 * 3) / 0.75, rel=1e-5)


def test_pairs_counted_before_the_transmittance_floor():
    """Twenty near-opaque layers over pixel (8, 8): there the third layer
    meets T < 1e-4 and only two pairs count; around it (the 0.3 px^2
    low-pass spreads each layer to a radius of 2) every pair counts until
    the pixel's own T falls under 1e-4, counted here pixel by pixel."""
    c = cam(16, 16)
    x = 0.5 / 50
    g = gaussians([[x * d, x * d, float(d)] for d in range(2, 22)],
                  scale=1e-4, opacity=0.9999)
    want = 0
    for py in range(16):
        for px in range(16):
            d2 = (px + 0.5 - 8.5) ** 2 + (py + 0.5 - 8.5) ** 2
            T = 1.0
            for d in range(2, 22):
                v = (1e-4 * 50 / d) ** 2 + 0.3
                a = min(0.999, 0.9999 * math.exp(-0.5 * d2 / v))
                if a < 1 / 255:
                    continue
                if T >= 1e-4:
                    want += 1
                T *= 1 - a
    out = RR.render(g, c, RASTER, 0, count=True)
    assert out["pairs"] == want
    assert out["alpha"][8, 8].item() == pytest.approx(1.0, abs=1e-5)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert RR.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


def test_ssim_and_l1_of_equal_images():
    img = torch.rand(20, 20, 3, generator=torch.Generator().manual_seed(0))
    assert RL.ssim(img, img, False).item() == pytest.approx(1.0, abs=1e-6)
    assert RL.ssim(img, 1 - img, False).item() < 0.5


def test_adam_first_step_moves_by_the_learning_rate():
    """Adam's first bias-corrected step is lr * sign(g) (eps aside)."""
    assert RS.learning_rate({"lr_init": 1.6e-4, "lr_final": 1.6e-6,
                             "max_steps": 100}, 50) == pytest.approx(1.6e-5)


def test_refine_places_duplicates_and_culls():
    """Slot 0 duplicated into the first free slot, slot 1 culled."""
    C = 4
    store = {k: torch.zeros((C,) + s) for k, s in (
        ("means", (3,)), ("quats", (4,)), ("log_scales", (3,)),
        ("logit_opacities", ()), ("features_dc", (3,)),
        ("features_rest", (15, 3)), ("normals", (3,)))}
    store["quats"][:, 0] = 1.0
    store["log_scales"][:] = math.log(0.001)
    store["means"][0] = torch.tensor([1.0, 2.0, 3.0])
    store["logit_opacities"][:] = 5.0
    store["logit_opacities"][1] = -5.0
    store["alive"] = torch.tensor([True, True, True, False])
    store["frozen"] = torch.zeros(C, dtype=torch.bool)
    for mom in RF.MOMENTS:
        store[mom] = {k: torch.ones_like(store[k]) for k in RS.LEAVES}
    store["stats"] = dict(grad2d_acc=torch.tensor([1.0, 0, 0, 0]),
                          count=torch.tensor([1, 1, 1, 0]),
                          max_radius=torch.zeros(C))
    adc = dict(stop_split_at=100, densify_grad_thresh=0.5,
               stop_screen_size_at=100, densify_size_thresh=0.01,
               split_screen_size=0.05, cull_alpha_thresh=0.1, warmup=0,
               reset_alpha_every=30, refine_every=10, cull_scale_thresh=0.5,
               cull_screen_size=0.15, split_scale_shrink=1.6,
               n_split_samples=2)
    out = RF.compact(RF.refine(store, adc, 10, torch.zeros(2, C, 3), False))
    # slot 1 culled and freed first: the duplicate lands there
    assert out["alive"].tolist() == [True, True, True, False]
    assert out["means"][1].tolist() == [1.0, 2.0, 3.0]
    assert out["m"]["means"][1].tolist() == [0.0, 0.0, 0.0]


def test_rotation_between_turns_z_onto_a_normal():
    n = torch.tensor([[0.0, 1.0, 0.0]])
    q = rotation_between(torch.tensor([[0.0, 0.0, 1.0]]), n)
    R = RR.quat_to_rotmat(q)[0]
    assert torch.allclose(R @ torch.tensor([0.0, 0, 1]), n[0], atol=1e-6)
