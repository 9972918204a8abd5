"""fs-render, the mask renderer and the batch runner in the port, against
the JAX package's, on the CPU: the parser's flags, each mode's cameras, a
2-frame dataset render of a port checkpoint (with learned pose deltas) on
the jax and flat backends (their plain versions here), mask_image /
mask_images byte for byte, and run_batch's summary.json."""
import dataclasses
import functools
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fusionsense_tpu.cli import render as CLIRJ
from fusionsense_tpu.data import dataparser as DPJ
from fusionsense_tpu.eval import batch as BJ
from fusionsense_tpu.eval import mask_render as MRJ
from fusionsense_tpu_torch import presets as PRT
from fusionsense_tpu_torch.cli import render as CLIRT
from fusionsense_tpu_torch.core.transforms import apply_se3_delta
from fusionsense_tpu_torch.data import dataparser as DPT
from fusionsense_tpu_torch.data.fixture import write_blob_scene
from fusionsense_tpu_torch.eval import batch as BT
from fusionsense_tpu_torch.eval import evaluator as EVT
from fusionsense_tpu_torch.eval import mask_render as MRT
from fusionsense_tpu_torch.gaussians.adc import init_stats
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.priors import visual_hull as VHT
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from fusionsense_tpu_torch.train.checkpoint import save_checkpoint
from fusionsense_tpu_torch.train.optim import init_adam

W, H, V = 64, 48, 3
CAM_ATOL = 1e-5      # float32 poses: torch's and XLA's quaternion math


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops on a shared CPU run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 3-view blob capture (2 views in its train split), both packages'
    parse of that split, and a port checkpoint of Gaussians on its seed
    cloud (SH degree 1) with a nonzero camera delta on train view 0."""
    root = tmp_path_factory.mktemp("render")
    scene = root / "scene"
    write_blob_scene(scene, n_views=V, width=W, height=H, focal=55.0,
                     n_gt=800, n_seed_pts=300, device="cpu")
    cfg_j = DPJ.DataParserConfig(data_dir=str(scene))
    cfg_t = DPT.DataParserConfig(data_dir=str(scene))
    sj, st = DPJ.parse_transforms(cfg_j), DPT.parse_transforms(cfg_t, "cpu")
    g = init_from_points(torch.from_numpy(st.seed_points),
                         torch.from_numpy(st.seed_colors), capacity=1024,
                         sh_degree=1, generator=torch.Generator().manual_seed(0))
    deltas = torch.tensor([[0.01, -0.02, 0.005, 0.01, 0.0, -0.01],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    ckpt = root / "run" / "ckpt_5"
    save_checkpoint(ckpt, g, init_adam(g.params()), init_stats(g.capacity, "cpu"),
                    5, cam_state=(deltas, init_adam({"d": deltas})))
    return dict(scene=scene, sj=sj, st=st, g=g, deltas=deltas, ckpt=ckpt,
                cam_j=DPJ.load_train_data(sj, cfg_j)[0],
                cam_t=DPT.load_train_data(st, cfg_t)[0])


def _actions(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.required, a.const,
                     a.type) for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """The JAX CLI's flags, dests, defaults, choices and types."""
    assert _actions(CLIRT.build_parser()) == _actions(CLIRJ.build_parser())


def _assert_cameras(ct, cj):
    assert (ct.width, ct.height) == (cj.width, cj.height)
    for f in ("viewmat", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), atol=CAM_ATOL,
                                   err_msg=f)


@pytest.mark.parametrize("spiral", [False, True])
def test_orbit_cameras_match_jax(capture, spiral):
    _assert_cameras(CLIRT._orbit_cameras(capture["cam_t"], 7, spiral=spiral),
                    CLIRJ._orbit_cameras(capture["cam_j"], 7, spiral=spiral))


def _ring_camera(pkg_make, n=4):
    """n poses far apart (the nlerp's hemisphere flip included)."""
    from fusionsense_tpu_torch.data.synthetic import look_at_w2c

    mats = [look_at_w2c(np.array([2 * np.cos(a), 2 * np.sin(a), 0.3 + 0.2 * a]),
                        np.zeros(3)) for a in np.linspace(0, 4.5, n)]
    ones = np.ones(n, np.float32)
    return pkg_make(np.stack(mats).astype(np.float32), 50 * ones, 51 * ones,
                    32 * ones, 24 * ones, W, H)


def test_interpolate_cameras_match_jax(capture):
    from fusionsense_tpu.core.cameras import make_camera as make_j
    from fusionsense_tpu_torch.core.cameras import make_camera as make_t

    _assert_cameras(CLIRT._interpolate_cameras(capture["cam_t"], 9),
                    CLIRJ._interpolate_cameras(capture["cam_j"], 9))
    _assert_cameras(
        CLIRT._interpolate_cameras(_ring_camera(
            functools.partial(make_t, device="cpu")), 11),
        CLIRJ._interpolate_cameras(_ring_camera(make_j), 11))


def test_rotmat_to_quat_matches_jax():
    """All four branches, and the ties between them (identity, 180-degree
    turns), pick JAX's quaternion."""
    from fusionsense_tpu.core import transforms as TJ
    from fusionsense_tpu_torch.core import transforms as TT

    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    R = np.asarray(TJ.quat_to_rotmat(jnp.asarray(q)))
    ties = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                     np.diag([-1.0, -1, 1]), np.diag([-1.0, -1, -1])])
    R = np.concatenate([R, ties.astype(np.float32)])
    got = TT.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(TJ.rotmat_to_quat(R)),
                               atol=2e-6)
    a, b = q[:8], q[8:16]
    np.testing.assert_allclose(
        TT.quat_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(TJ.quat_mul(a, b)), atol=1e-6)
    np.testing.assert_array_equal(TT.quat_invert(torch.from_numpy(a)).numpy(),
                                  np.asarray(TJ.quat_invert(a)))


def _camera_path(path):
    frames = []
    for i, (a, fov) in enumerate([(0.0, 50.0), (0.7, 60.0), (1.9, None)]):
        eye = np.array([1.5 * np.cos(a), 1.5 * np.sin(a), 0.4])
        from fusionsense_tpu_torch.data.synthetic import look_at_w2c

        c2w = np.linalg.inv(look_at_w2c(eye, np.zeros(3))) @ np.diag(
            [1.0, -1.0, -1.0, 1.0])
        fr = {"camera_to_world": c2w.reshape(-1).tolist()}
        if fov is not None:
            fr["fov"] = fov
        frames.append(fr)
    path.write_text(json.dumps({"camera_path": frames}))
    return path


def test_camera_path_matches_jax(capture, tmp_path):
    p = _camera_path(tmp_path / "camera_path.json")
    _assert_cameras(CLIRT._load_camera_path(p, capture["cam_t"], capture["st"]),
                    CLIRJ._load_camera_path(p, capture["cam_j"], capture["sj"]))


class _Built(Exception):
    """Raised in place of JAX's make_render_fn, once the camera is built."""


def _jax_main_camera(monkeypatch, argv, cam_state):
    """The camera that JAX's fs-render main builds for argv, with its
    checkpoint read replaced by one returning cam_state (numpy arrays),
    stopped before the first render."""
    import fusionsense_tpu.eval.evaluator as EVJ
    import fusionsense_tpu.train.checkpoint as CKJ

    got = {}

    def capture(cfg, camera):
        got["camera"] = camera
        raise _Built

    monkeypatch.setattr(CKJ, "load_for_inference",
                        lambda path: (None, None, cam_state))
    monkeypatch.setattr(EVJ, "make_render_fn", capture)
    with pytest.raises(_Built):
        CLIRJ.main(argv)
    return got["camera"]


@pytest.mark.parametrize("case", ["deltas", "zero_deltas", "wrong_count",
                                  "test_split", "no_cam_state", "spiral"])
def test_dataset_mode_cameras_match_jax_main(capture, tmp_path, monkeypatch,
                                             case):
    """The cameras fs-render builds before rendering, against the ones
    JAX's main builds from the same deltas: the deltas go onto the train
    split's poses only in dataset mode, only when they are nonzero and
    one per view, and before the mode switch."""
    d = capture["deltas"].numpy()
    deltas, mode, extra = {
        "deltas": (d, "dataset", []),
        "zero_deltas": (np.zeros_like(d), "dataset", []),
        "wrong_count": (np.concatenate([d, d[:1]]), "dataset", []),
        "test_split": (d[:1], "dataset", ["--split", "test"]),
        "no_cam_state": (None, "dataset", []),
        "spiral": (d, "spiral", ["--n-frames", "3"]),
    }[case]
    argv = [mode, "--checkpoint", "unused", "--data", str(capture["scene"]),
            "--output-dir", str(tmp_path / "r"), *extra]
    state = None if deltas is None else (deltas, None)
    cam_j = _jax_main_camera(monkeypatch, argv, state)
    monkeypatch.setattr(
        "fusionsense_tpu_torch.train.checkpoint.load_for_inference",
        lambda path, device=None: (capture["g"], None, None if deltas is None
                                   else (torch.from_numpy(deltas), None)))
    _, cam_t = CLIRT.render_inputs(CLIRT.build_parser().parse_args(argv),
                                   device="cpu")
    _assert_cameras(cam_t, cam_j)
    if case == "test_split":
        assert cam_t.viewmat.shape[0] == 1
    elif mode == "dataset":
        moved = not torch.equal(cam_t.viewmat, capture["cam_t"].viewmat)
        assert moved == (case == "deltas")


@pytest.mark.parametrize("backend", ["jax", "flat"])
def test_dataset_render_of_a_port_checkpoint(capture, tmp_path, backend):
    """fs-render dataset on the train split renders each view at the
    optimised pose and the checkpoint's SH degree: the PNGs are the
    render's, quantised as JAX's _save_image quantises them."""
    out = tmp_path / "r"
    n = CLIRT.main(["dataset", "--checkpoint", str(capture["ckpt"]), "--data",
                    str(capture["scene"]), "--output-dir", str(out),
                    "--backend", backend], device="cpu")
    cam = capture["cam_t"]
    assert n == cam.viewmat.shape[0] == 2
    cam = cam.replace(viewmat=apply_se3_delta(cam.viewmat, capture["deltas"]))
    render = EVT.make_render_fn(RCT(backend=backend, sh_degree=1), cam)
    for i in range(n):
        o = render(capture["g"], i)
        rgb = np.asarray(Image.open(out / "rgb" / f"{i:05d}.png"))
        want = (np.clip(o.rgb.numpy(), 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(rgb, want)
        assert rgb.std() > 0
        depth = np.asarray(Image.open(out / "depth" / f"{i:05d}.png"))
        assert depth.shape == (H, W, 3) and depth.max() == 255
        nrm = np.asarray(Image.open(out / "normal" / f"{i:05d}.png"))
        want = (np.clip(o.normal.numpy() * 0.5 + 0.5, 0, 1) * 255).astype(
            np.uint8)
        np.testing.assert_array_equal(nrm, want)


def test_spiral_mode_renders_its_frames(capture, tmp_path):
    out = tmp_path / "s"
    n = CLIRT.main(["spiral", "--checkpoint", str(capture["ckpt"]), "--data",
                    str(capture["scene"]), "--output-dir", str(out),
                    "--n-frames", "2"], device="cpu")
    assert n == 2 and len(list((out / "rgb").iterdir())) == 2


def test_mask_images_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(3)
    renders, masks = tmp_path / "renders", tmp_path / "masks"
    renders.mkdir()
    masks.mkdir()
    for i in range(3):
        Image.fromarray((rng.uniform(size=(H, W, 3)) * 255).astype(
            np.uint8)).save(renders / f"{i:05d}.png")
        if i != 1:          # a render without a mask is skipped
            Image.fromarray((rng.uniform(size=(H, W)) > 0.5).astype(
                np.uint8) * 255).save(masks / f"{i:05d}.png")
    rgb = rng.uniform(size=(H, W, 3)).astype(np.float32)
    mask = rng.uniform(size=(H, W)).astype(np.float32)
    for bg in (1.0, 0.0):
        np.testing.assert_array_equal(MRT.mask_image(rgb, mask, bg),
                                      MRJ.mask_image(rgb, mask, bg))
    assert MRT.mask_images(renders, masks, tmp_path / "t") == \
        MRJ.mask_images(renders, masks, tmp_path / "j") == 2
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_run_batch_records_results_and_errors(capture, tmp_path, monkeypatch):
    """One 2-iteration job and one on a directory without a capture: the
    sweep goes on past the failure, and the error record is JAX's."""
    base = PRT.dn_splatter()
    small = dataclasses.replace(
        base, model=dataclasses.replace(
            base.model, capacity=4096, sh_degree=1,
            rasterize=dataclasses.replace(base.model.rasterize,
                                          tile_capacity=256, sh_degree=1)))
    monkeypatch.setitem(PRT.PRESETS, "dn-splatter", lambda: small)
    monkeypatch.setattr("fusionsense_tpu_torch.pipeline.visual_hull",
                        functools.partial(VHT.visual_hull,
                                          cfg=VHT.VisualHullConfig(
                                              voxel_size=0.02)))
    scene = tmp_path / "scene"
    shutil.copytree(capture["scene"], scene)
    bad = str(tmp_path / "no_capture")
    jobs = [BT.BatchJob(data_dir=str(scene), iterations=2),
            BT.BatchJob(data_dir=bad, name="bad")]
    res = BT.run_batch(jobs, output_dir=tmp_path / "t", log=None, device="cpu")
    summary = json.loads((tmp_path / "t" / "summary.json").read_text())
    assert summary == json.loads(json.dumps(res, default=str))
    ok, err = summary
    assert ok["status"] == "ok" and ok["job"] == "scene_dn-splatter"
    assert np.isfinite(ok["psnr"]) and ok["num_gaussians"] > 0
    assert err["status"].startswith("error: ")
    want = BJ.run_batch([BJ.BatchJob(data_dir=bad, name="bad")],
                        output_dir=tmp_path / "j", log=None)
    jax_err = json.loads((tmp_path / "j" / "summary.json").read_text())[0]
    assert want[0]["status"] == jax_err["status"] == err["status"]
    assert set(jax_err) == set(err) == {"status", "wall_s", "job"}
