"""The port's data layer against the JAX package's, and its image files
against Pillow: the same files on disk go through both parsers; scenes
written by the JAX fixture writers are parsed and loaded by both packages;
the port's own writers are held against JAX's."""
import json
import shutil
import sys
import tarfile
import urllib.error

import numpy as np
import pytest
import torch

from fusionsense_tpu.data import colmap as COLJ
from fusionsense_tpu.data import dataparser as DPJ
from fusionsense_tpu.data import dataset_variants as DVJ
from fusionsense_tpu.data import fixture as FXJ
from fusionsense_tpu.data import synthetic as SYNJ
from fusionsense_tpu.data import undistort as UDJ
from fusionsense_tpu_torch.data import colmap as COLT
from fusionsense_tpu_torch.data import dataparser as DPT
from fusionsense_tpu_torch.data import dataset_variants as DVT
from fusionsense_tpu_torch.data import fixture as FXT
from fusionsense_tpu_torch.data import image_io as IO
from fusionsense_tpu_torch.data import synthetic as SYNT
from fusionsense_tpu_torch.data import undistort as UDT
from fusionsense_tpu_torch.utils.ply import read_ply, write_ply
from test_dataset_variants import (
    _write_colmap_model, _write_mushroom_capture, ring_c2w, write_depth,
    write_img,
)

W, H = 64, 48


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops on a shared CPU run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ image files ----

def _images(seed=0, h=23, w=37):
    """One array per image flavour the captures use, with Pillow's mode."""
    rng = np.random.RandomState(seed)
    u8 = lambda *s: (rng.rand(h, w, *s) * 256).astype(np.uint8)  # noqa: E731
    return {"L": u8(), "LA": u8(2), "RGB": u8(3), "RGBA": u8(4),
            "I;16": (rng.rand(h, w) * 65536).astype(np.uint16)}


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_png_round_trips_with_pillow(tmp_path, mode):
    """Files Pillow wrote read bit-equal; Pillow reads the port's files
    bit-equal (16-bit gray stays uint16)."""
    Image = pytest.importorskip("PIL.Image")
    arr = _images()[mode]
    Image.fromarray(arr).save(tmp_path / "pil.png")
    got = IO.read_image(tmp_path / "pil.png")
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)
    IO.write_png(tmp_path / "sub" / "port.png", arr)
    back = Image.open(tmp_path / "sub" / "port.png")
    assert back.mode == mode
    np.testing.assert_array_equal(np.asarray(back), arr)
    assert IO.image_size(tmp_path / "sub" / "port.png") == (arr.shape[1],
                                                             arr.shape[0])


@pytest.mark.parametrize("factor", [2, 3])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_load_image_matches_jax(tmp_path, mode, factor):
    """The dataparsers' image loader with its bilinear downscale: equal
    arrays, (H, W, C) in the file's dtype."""
    pytest.importorskip("PIL.Image")
    arr = _images(2, h=50, w=71)[mode]
    IO.write_png(tmp_path / "a.png", arr)
    want = DPJ._load_image(tmp_path / "a.png", factor)
    got = IO.load_image(tmp_path / "a.png", factor)
    assert got.dtype == arr.dtype and got.shape == want.shape
    assert got.shape[:2] == (50 // factor, 71 // factor)
    np.testing.assert_array_equal(got, want)


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    """JPEG reads as Pillow reads it; without Pillow, .npy still loads and
    an image file raises an ImportError that names it."""
    Image = pytest.importorskip("PIL.Image")
    arr = _images()["RGB"]
    Image.fromarray(arr).save(tmp_path / "a.jpg")
    np.testing.assert_array_equal(IO.read_image(tmp_path / "a.jpg"),
                                  np.asarray(Image.open(tmp_path / "a.jpg")))
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(IO.read_image(tmp_path / "a.npy"), arr)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="a.jpg"):
        IO.read_image(tmp_path / "a.jpg")
    np.testing.assert_array_equal(
        IO.read_image(tmp_path / "a.npy"), arr)


# ----------------------------------------------------- transforms.json ----

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX writers' sphere scene (with a touch patch) and blob scene,
    and the port's blob scene from the same arguments."""
    root = tmp_path_factory.mktemp("scenes")
    FXJ.write_synthetic_scene(root / "sphere", n_views=4, width=W, height=H,
                              focal=50.0, n_gt=600, with_touches=True)
    kw = dict(n_views=4, width=W, height=H, focal=55.0, n_gt=800,
              n_seed_pts=200)
    FXJ.write_blob_scene(root / "blob", **kw)
    FXT.write_blob_scene(root / "blob_port", device="cpu", **kw)
    # a hull prior registered as the pipeline registers one
    shutil.copytree(root / "blob", root / "blob_hull")
    write_ply(root / "blob_hull" / "hull.ply",
              np.asarray(SYNJ.blob_points(n=300)[0]) * 0.9)
    meta = json.loads((root / "blob_hull" / "transforms.json").read_text())
    meta["object_pc_path"] = "hull.ply"
    (root / "blob_hull" / "transforms.json").write_text(json.dumps(meta))
    return root


def _same_cameras(ct, cj):
    for k in ("viewmat", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(_np(getattr(ct, k)), np.asarray(getattr(cj, k)),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert (ct.width, ct.height) == (cj.width, cj.height)


def _same_scene(st, sj):
    _same_cameras(st.cameras, sj.cameras)
    for k in ("image_paths", "depth_paths", "mono_depth_paths", "normal_paths",
              "mask_paths"):
        assert getattr(st, k) == getattr(sj, k), k
    for k in ("train_idx", "val_idx", "test_idx", "translate"):
        np.testing.assert_array_equal(getattr(st, k), getattr(sj, k), err_msg=k)
    assert st.scale == sj.scale and st.depth_unit_scale == sj.depth_unit_scale
    for k in ("seed_points", "seed_colors", "seed_normals", "hull_points"):
        a, b = getattr(st, k), getattr(sj, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=k)
    assert (st.touch_patches is None) == (sj.touch_patches is None)
    for pt, pj in zip(st.touch_patches or [], sj.touch_patches or []):
        for k in ("points", "colors", "normals", "bbox_center", "bbox_rot",
                  "bbox_extent"):
            np.testing.assert_array_equal(getattr(pt, k), getattr(pj, k), k)


def _same_train_data(dt, dj):
    for k in ("images", "sensor_depths", "mono_depths", "normals", "masks"):
        a, b = getattr(dt, k), getattr(dj, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=k)


@pytest.mark.parametrize("name,down", [("sphere", 1), ("blob_hull", 1),
                                       ("blob", 2)])
def test_parse_and_load_match_jax(scenes, name, down):
    """Cameras within 1e-6; paths, splits, seed and hull points, touch
    patches; every loaded image, depth, normal and mask equal (a
    downscale_factor=2 case goes through the bilinear downscale)."""
    kw = dict(data_dir=str(scenes / name), load_touches=True,
              downscale_factor=down)
    cfg_j, cfg_t = DPJ.DataParserConfig(**kw), DPT.DataParserConfig(**kw)
    sj, st = DPJ.parse_transforms(cfg_j), DPT.parse_transforms(cfg_t, "cpu")
    _same_scene(st, sj)
    for split in ("train", "test"):
        cj, dj = DPJ.load_train_data(sj, cfg_j, split)
        ct, dt = DPT.load_train_data(st, cfg_t, split)
        _same_cameras(ct, cj)
        _same_train_data(dt, dj)
    assert dt.images.shape == (1, H // down, W // down, 3)
    if name == "sphere":
        assert len(st.touch_patches) == 1
    if name == "blob_hull":
        assert st.hull_points.shape == (300, 3)


def test_write_blob_scene_matches_jax(scenes):
    """The port's writer against JAX's at 64x48: transforms.json within
    1e-6, masks, PLYs, the tactile patch and its transform equal, normals
    within 1e-4 (autograd against jax.grad of the same implicit). Images
    within one level and depth within 1 mm: the GT images come from each
    package's rasterizer in float32, and the depth is truncated to whole
    millimetres after float32 ray marching, so a value within float error
    of a level boundary may land on either side."""
    j, t = scenes / "blob", scenes / "blob_port"
    mj = json.loads((j / "transforms.json").read_text())
    mt = json.loads((t / "transforms.json").read_text())
    assert set(mj) == set(mt) and mj["train_filenames"] == mt["train_filenames"]
    for a, b in zip(mj["frames"], mt["frames"]):
        assert set(a) == set(b)
        np.testing.assert_allclose(b["transform_matrix"], a["transform_matrix"],
                                   atol=1e-6, rtol=0)
        for k in ("fl_x", "fl_y", "cx", "cy", "w", "h", "file_path"):
            assert a[k] == b[k]
    for fr in mj["frames"]:
        name = fr["file_path"].split("/")[-1]
        img = [IO.read_image(d / "images" / name).astype(int) for d in (j, t)]
        assert np.abs(img[0] - img[1]).max() <= 1
        dep = [IO.read_image(d / "depths" / name).astype(int) for d in (j, t)]
        assert np.abs(dep[0] - dep[1]).max() <= 1
        np.testing.assert_array_equal(*[IO.read_image(d / "masks" / name)
                                        for d in (j, t)])
        np.testing.assert_allclose(
            *[np.load(d / "normals" / (name + ".npy")) for d in (t, j)],
            atol=1e-4, rtol=0)
    for f in ("seed.ply", "gt_points.ply"):
        a, b = read_ply(t / f), read_ply(j / f)
        np.testing.assert_allclose(a["points"], b["points"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(a["colors"], b["colors"])
    for f in ("tactile/gelsight_transform.json", "tactile/patch_0.pcd"):
        assert (t / f).read_bytes() == (j / f).read_bytes(), f


def test_write_synthetic_and_hard_scenes_parse(tmp_path):
    """The port's sphere and hard writers produce scenes its parser loads:
    images, 16-bit depth, masks, normals and the seed cloud."""
    FXT.write_synthetic_scene(tmp_path / "s", n_views=3, width=32, height=24,
                              focal=30.0, n_gt=300, with_touches=True,
                              device="cpu")
    FXT.write_hard_scene(tmp_path / "h", n_views=3, width=32, height=24,
                         focal=30.0, n_seed_pts=100, device="cpu")
    for name, touches in (("s", 1), ("h", None)):
        cfg = DPT.DataParserConfig(data_dir=str(tmp_path / name),
                                   load_touches=True)
        scene = DPT.parse_transforms(cfg, "cpu")
        cam, data = DPT.load_train_data(scene, cfg)
        assert data.images.shape == (2, 24, 32, 3)
        assert float(data.masks.sum()) > 0 and float(data.sensor_depths.max()) > 0
        assert scene.seed_points.shape[1] == 3
        assert (scene.touch_patches and len(scene.touch_patches)) == touches
    assert IO.read_image(tmp_path / "h/depths/frame_00000.png").dtype == np.uint16


# ------------------------------------------------------ synthetic scenes ---

def test_blob_and_hard_helpers_match_jax():
    """Surface samples within 1e-6 and normals within 1e-6 (the hard
    object's off its creases); the ray-marched
    depth within 1e-4 and normals within 1e-4 with identical hit masks; the
    shaded hard view within 1e-4 (float32 bisection and autograd against
    XLA's)."""
    for a, b in zip(SYNT.blob_points(n=500, device="cpu"),
                    SYNJ.blob_points(n=500)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)
    got, want = SYNT.hard_points(n=300, device="cpu"), SYNJ.hard_points(n=300)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)
    # a point on a crease of the union (blob / torus / dent) takes either
    # side's gradient under float32 ties: allow 1% of the normals there
    off = np.abs(_np(got[2]) - np.asarray(want[2])).max(-1) > 1e-5
    assert off.mean() <= 0.01, off.sum()
    cj = SYNJ.ring_cameras(n_views=3, width=W, height_px=H, focal=55.0)
    ct = SYNT.ring_cameras(n_views=3, width=W, height_px=H, focal=55.0,
                           device="cpu")
    for fn in ("blob_depth_normals", "hard_depth_normals", "shade_hard_view"):
        for i in (0, 2):
            got = getattr(SYNT, fn)(ct.index(i))
            want = getattr(SYNJ, fn)(cj.index(i))
            np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
            assert float(got[2].sum()) > 50
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4,
                                           rtol=0, err_msg=fn)


# ------------------------------------------------------ dataset layouts ----

def _layout(kind, root):
    """Write one small capture of `kind` under root; returns parse_dataset's
    keyword arguments."""
    if kind == "replica":
        np.savetxt(root / "traj.txt", ring_c2w(6).reshape(6, 16))
        for i in range(6):
            write_img(root / "results" / f"frame{i:06d}.jpg", 60, 34)
            write_depth(root / "results" / f"depth{i:06d}.png", 60, 34,
                        val=13107 + 100 * i)
        return dict(test_every=3)
    if kind == "colmap":
        _write_colmap_model(root / "sparse/0", 4,
                            "1 PINHOLE 32 24 30.0 30.0 16.0 12.0")
        with open(root / "sparse/0/points3D.txt", "w") as f:
            f.write("# points\n")
            for i in range(20):
                f.write(f"{i} {i * 0.1} 0.0 1.0 128 64 {i} 0.5\n")
        for i in range(4):
            write_img(root / "images" / f"img_{i:03d}.png")
        return dict(test_every=4)
    if kind == "sdfstudio":
        frames = []
        for i, c2w in enumerate(ring_c2w(3)):
            write_img(root / f"{i:06d}_rgb.png")
            frames.append({"rgb_path": f"{i:06d}_rgb.png",
                           "camtoworld": c2w.tolist(),
                           "intrinsics": [[30.0, 0, 16.0, 0], [0, 30.0, 12.0, 0],
                                          [0, 0, 1, 0], [0, 0, 0, 1]]})
        (root / "meta_data.json").write_text(json.dumps({"frames": frames}))
        return dict(test_every=2)
    if kind == "nrgbd":
        np.savetxt(root / "trajectory.txt", ring_c2w(4).reshape(-1, 4))
        for i in range(4):
            write_img(root / "images" / f"img{i}.png")
            write_depth(root / "depth" / f"depth{i}.png")
        return dict(test_every=2)
    if kind.startswith("mushroom"):
        _write_mushroom_capture(root / "kinect" / "long_capture", 12, "l")
        _write_mushroom_capture(root / "kinect" / "short_capture", 3, "s")
        return dict(sensor="kinect", eval_mode=kind.split("-")[1])
    seq = "s1"
    if kind == "scannetpp-dslr":
        base = root / seq / "dslr"
        inner = base / "undistort_colmap" / seq
        names = [f"DSC{i:05d}.png" for i in range(5)]
        _write_colmap_model(inner / "colmap", 5,
                            "1 PINHOLE 32 24 30.0 30.0 16.0 12.0", names)
        for n in names:
            write_img(inner / "images" / n)
            write_img(inner / "masks" / n)
        (base / "train_test_lists.json").write_text(
            json.dumps({"train": names[:4], "test": names[4:]}))
        return dict(sequence=seq, mode="dslr")
    base = root / seq / "iphone"
    _write_colmap_model(base / "colmap", 3,
                        "1 OPENCV 32 24 30.0 30.0 16.0 12.0 0.05 -0.01 0 0")
    for i in range(3):
        write_img(base / "rgb" / f"img_{i:03d}.png")
        write_depth(base / "depth" / f"img_{i:03d}.png")
    return dict(sequence=seq, mode="iphone", test_every=3)


@pytest.mark.parametrize("kind", [
    "replica", "colmap", "sdfstudio", "nrgbd", "mushroom-within",
    "mushroom-with", "mushroom-all", "scannetpp-dslr", "scannetpp-iphone"])
def test_dataset_layouts_match_jax(tmp_path, kind):
    """Each layout parsed by both packages from the same files (separate
    copies, since the iphone layout writes an undistortion cache): the same
    scene, and the same loaded train split. Replica carries its 1/6553.5
    depth unit on the scene, so a caller's default mm unit does not apply."""
    pytest.importorskip("PIL.Image")
    (tmp_path / "j").mkdir()
    kw = _layout(kind, tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    layout = kind.split("-")[0]
    cfg_j = DPJ.DataParserConfig(data_dir=str(tmp_path / "j"))
    cfg_t = DPT.DataParserConfig(data_dir=str(tmp_path / "t"))
    sj = DVJ.parse_dataset(layout, cfg_j, **kw)
    st = DVT.parse_dataset(layout, cfg_t, device="cpu", **kw)
    rel = lambda ps, d: [None if p is None else p.relative_to(d)  # noqa: E731
                         for p in ps]
    for k in ("image_paths", "depth_paths", "mask_paths", "normal_paths"):
        assert rel(getattr(st, k), tmp_path / "t") == rel(getattr(sj, k),
                                                          tmp_path / "j"), k
        setattr(st, k, getattr(sj, k))     # same files for the loaders below
    _same_scene(st, sj)
    cj, dj = DPJ.load_train_data(sj, cfg_j, "train")
    ct, dt = DPT.load_train_data(st, cfg_t, "train")
    _same_cameras(ct, cj)
    _same_train_data(dt, dj)
    if kind == "replica":
        assert st.depth_unit_scale == DVT.REPLICA_DEPTH_SCALE
        raw = 13107 + 100 * int(st.train_idx[0])
        np.testing.assert_allclose(
            float(dt.sensor_depths[0, 0, 0]),
            raw * DVT.REPLICA_DEPTH_SCALE * st.scale, rtol=1e-6)


def test_colmap_readers_and_undistort_match_jax(tmp_path):
    _write_colmap_model(tmp_path, 4, "1 OPENCV 32 24 30.0 31.0 16.0 12.0 "
                        "0.05 -0.01 0.001 0.002")
    with open(tmp_path / "points3D.txt", "w") as f:
        f.write("# points\n")
        for i in range(30):
            f.write(f"{i} {i * 0.1} {-i * 0.2} 1.0 {i} 64 32 0.5 1 2\n")
    cams = [m.read_cameras_txt(tmp_path / "cameras.txt") for m in (COLT, COLJ)]
    assert cams[0].keys() == cams[1].keys()
    for k in cams[0]:
        a, b = cams[0][k], cams[1][k]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
        assert a.intrinsics() == b.intrinsics()
    ims = [m.read_images_txt(tmp_path / "images.txt") for m in (COLT, COLJ)]
    assert len(ims[0]) == len(ims[1]) == 4
    for a, b in zip(ims[0], ims[1]):
        assert (a["name"], a["camera_id"]) == (b["name"], b["camera_id"])
        np.testing.assert_array_equal(a["w2c"], b["w2c"])
    for u, v in zip(COLT.read_points3d_txt(tmp_path / "points3D.txt", 20),
                    COLJ.read_points3d_txt(tmp_path / "points3D.txt", 20)):
        np.testing.assert_array_equal(u, v)

    rng = np.random.RandomState(0)
    img = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
    K = np.array([[30.0, 0, 16], [0, 31.0, 12], [0, 0, 1]])
    for model, params in (("OPENCV", [0.05, -0.01, 0.001, 0.002]),
                          ("OPENCV_FISHEYE", [0.1, 0.01, 0.0, 0.0])):
        np.testing.assert_array_equal(
            UDT.undistort_image(img, K, params, model),
            UDJ.undistort_image(img, K, params, model))
    write_img(tmp_path / "in" / "a.png")
    for m, d in ((UDT, "t"), (UDJ, "j")):
        m.undistort_to_cache([tmp_path / "in" / "a.png"], K,
                             [0.05, -0.01, 0, 0], "OPENCV", tmp_path / d)
    np.testing.assert_array_equal(IO.read_image(tmp_path / "t" / "a.png"),
                                  IO.read_image(tmp_path / "j" / "a.png"))


# ------------------------------------------------------------ download -----

def test_download_offline(tmp_path, monkeypatch):
    """The registry as JAX's; fetch from a file:// archive extracts it and
    skips it on a re-run; an unreachable host (a failing opener, no network
    touched) raises listing every URL to mirror."""
    from fusionsense_tpu.data import download as DLJ
    from fusionsense_tpu_torch.data import download as DLT

    assert set(DLT.REGISTRY) == set(DLJ.REGISTRY)
    for name in ("replica", "dtu", "nrgbd", "omnidata"):
        assert DLT.REGISTRY[name]() == [DLT.Artifact(**vars(a))
                                        for a in DLJ.REGISTRY[name]()]
    assert DLT.REGISTRY["mushroom"](room="sauna", sequence="all") == [
        DLT.Artifact(**vars(a))
        for a in DLJ.REGISTRY["mushroom"](room="sauna", sequence="all")]

    src = tmp_path / "stage" / "capture"
    src.mkdir(parents=True)
    (src / "transforms.json").write_text("{}")
    archive = tmp_path / "room.tar.gz"
    with tarfile.open(archive, "w:gz") as tf:
        tf.add(src, arcname="capture")
    monkeypatch.setitem(DLT.REGISTRY, "mushroom", lambda room, sequence: [
        DLT.Artifact(archive.as_uri(), extract_to=room)])
    quiet = lambda *a, **k: None  # noqa: E731
    kw = dict(room="activity", sequence="iphone", log=quiet)
    out = DLT.fetch("mushroom", tmp_path / "d", **kw)
    assert out == [tmp_path / "d" / "activity"]
    assert (out[0] / "capture" / "transforms.json").read_text() == "{}"
    assert not (tmp_path / "d" / "room.tar.gz").exists()
    archive.unlink()               # a re-run must not fetch again
    assert DLT.fetch("mushroom", tmp_path / "d", **kw) == out

    def offline(*a, **k):
        raise urllib.error.URLError("no route to host")
    monkeypatch.setattr(DLT.urllib.request, "urlopen", offline)
    with pytest.raises(RuntimeError) as ei:
        DLT.fetch("nrgbd", tmp_path / "n", log=quiet)
    assert "neural_rgbd_data.zip" in str(ei.value)
    assert "meshes.zip" in str(ei.value)
