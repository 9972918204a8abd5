"""The port's Active Touch Selection (fusionsense_tpu_torch/touch_select,
cli/touch.py, native.py) against the JAX package's, on the CPU.

Exact where JAX's result is exact: the z-buffer's index map and depth, the
superpoint labels (both packages' cut-pursuit, each built from
native/cutpursuit.cpp, on the same features), segment_parts with the
geometric fixture detector of tests/test_touch_select.py, the proposals
and the files next_best_touches and fs-touch write. The clouds here hold
no duplicate points: scikit-learn's k-NN (JAX) and scipy's cKDTree (the
port) agree on neighbour sets and order only where distances are
distinct, and the self-drop `[:, 1:]` assumes each point is its own
first neighbour.
"""
import numpy as np
import pytest
import torch

from fusionsense_tpu import native as JN
from fusionsense_tpu.touch_select import partseg as JP
from fusionsense_tpu.touch_select import proposals as JPr
from fusionsense_tpu.touch_select import vlm as JV
from fusionsense_tpu_torch import native as TN
from fusionsense_tpu_torch.touch_select import partseg as TP
from fusionsense_tpu_torch.touch_select import proposals as TPr
from fusionsense_tpu_torch.touch_select import vlm as TV

from test_touch_select import GeometricDetector, two_blob_cloud


class PortGeometricDetector(GeometricDetector):
    """The fixture detector, returning the port's Detection."""

    def detect(self, rgb, part_names):
        d = super().detect(rgb, part_names)
        return TP.Detection(boxes=d.boxes, labels=d.labels, scores=d.scores)


def _cloud(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 0.3).astype(np.float32)
    return pts, rng.rand(n, 3).astype(np.float32)


def test_normalize_and_viewpoints():
    pts, _ = _cloud()
    for a, b in zip(TP.normalize_pc(pts * 3 + 1), JP.normalize_pc(pts * 3 + 1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TP.fixed_viewpoints(10),
                                  JP.fixed_viewpoints(10))


@pytest.mark.parametrize("size", [64, 160])
def test_zbuffer_render_is_jax_map_exactly(size):
    """Index map, depth and colours equal to JAX's CPU render, with exact
    depth ties (a duplicated half of the cloud: the lower index wins) and
    points behind the camera."""
    pts, cols = _cloud(4000)
    pts = np.concatenate([pts, pts[:500], pts[:200] * 8]).astype(np.float32)
    cols = np.concatenate([cols, cols[:500] * 0.5, cols[:200]])
    for m in JP.fixed_viewpoints(6).astype(np.float32):
        focal = 0.9 * size / 2
        want = JP._zbuffer_render(pts, cols, m, focal, size=size)
        got = TP._zbuffer_render(torch.from_numpy(pts), torch.from_numpy(cols),
                                 torch.from_numpy(m), focal, size=size)
        idx = np.asarray(want[1])
        assert (idx >= 4000).any() and (idx >= 0).sum() > 100
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_render_views():
    pts, cols = _cloud(2000, seed=1)
    norm, *_ = JP.normalize_pc(pts)
    want = JP.render_views(norm, cols, n_views=4, size=96)
    got = TP.render_views(norm, cols, n_views=4, size=96, device="cpu")
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["focal"] == w["focal"]
        for k in ("rgb", "idx", "depth", "viewmat"):
            np.testing.assert_array_equal(g[k], w[k])


def test_native_library_builds_into_build_dir():
    so = TN.build()
    assert so.parent == TN.BUILD_DIR and so.name.startswith("cutpursuit-")
    assert TN.load() is TN.load()


def test_cutpursuit_and_fh_segment_match_jax():
    JN._load()          # JAX's native library loads (or the test is moot)
    rng = np.random.RandomState(0)
    feats = np.concatenate([rng.randn(150, 4) * 0.05,
                            rng.randn(150, 4) * 0.05 + 2.0]).astype(np.float32)
    src = np.repeat(np.arange(300), 4).astype(np.uint32)
    dst = rng.randint(0, 300, 1200).astype(np.uint32)
    w = rng.rand(1200).astype(np.float64)     # converted inside the call
    for reg in (0.001, 0.05, 1e6):
        np.testing.assert_array_equal(
            TN.cutpursuit(feats, src, dst, edge_w=w, reg=reg),
            JN.cutpursuit(feats, src, dst, edge_w=w, reg=reg))
    np.testing.assert_array_equal(TN.cutpursuit(feats, src, dst, reg=0.01),
                                  JN.cutpursuit(feats, src, dst, reg=0.01))
    np.testing.assert_array_equal(
        TN.fh_segment(feats, src, dst, edge_w=w, k=0.1, min_size=5),
        JN.fh_segment(feats, src, dst, edge_w=w, k=0.1, min_size=5))


@pytest.mark.parametrize("k", [8, 10])
def test_normals_and_superpoints_match_jax(k):
    JN._load()
    pts, _ = two_blob_cloud()
    norm, *_ = JP.normalize_pc(pts)
    np.testing.assert_array_equal(TP._knn(norm, k + 1)[:, 0],
                                  np.arange(len(norm)))
    np.testing.assert_allclose(np.abs(TP.estimate_normals(norm, k)),
                               np.abs(JP.estimate_normals(norm, k)),
                               atol=1e-6)
    labels = TP.superpoints(norm, k=k, min_size=5)
    np.testing.assert_array_equal(labels, JP.superpoints(norm, k=k,
                                                         min_size=5))
    assert labels.max() >= 1


def test_region_grow_and_merge_small():
    pts, _ = two_blob_cloud(n=200, seed=2)
    normals = JP.estimate_normals(pts, 8)
    nbr = TP._knn(pts, 9)[:, 1:]
    grown = TP._region_grow(pts, normals, nbr, angle_thresh=0.9)
    np.testing.assert_array_equal(grown, JP._region_grow(pts, normals, nbr,
                                                         angle_thresh=0.9))
    np.testing.assert_array_equal(TP._merge_small(grown, nbr, 6),
                                  JP._merge_small(grown, nbr, 6))


def test_bbox_vote():
    rng = np.random.RandomState(3)
    views = [{"idx": rng.randint(-1, 50, (20, 24))} for _ in range(3)]
    dets = [JP.Detection(boxes=rng.uniform(0, 24, (4, 4)),
                         labels=list(rng.randint(0, 3, 4)),
                         scores=np.ones(4)) for _ in views]
    sp = rng.randint(0, 7, 50)
    for thr in (0.2, 0.5):
        np.testing.assert_array_equal(
            TP.bbox_vote(views, dets, sp, 3, thr),
            JP.bbox_vote(views, dets, sp, 3, thr))


def test_segment_parts_matches_jax():
    JN._load()
    pts, cols = two_blob_cloud()
    kw = dict(n_views=6, render_size=160, sp_k=8)
    want = JP.segment_parts(pts, cols, ["red part", "blue part"],
                            GeometricDetector(), **kw)
    got = TP.segment_parts(pts, cols, ["red part", "blue part"],
                           PortGeometricDetector(), device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert (want[:200] == 0).mean() > 0.6 and (want[200:] == 1).mean() > 0.6


def test_fuse_and_propose_match_jax():
    rng = np.random.RandomState(0)
    seg_pts = rng.rand(200, 3)
    seg_rank = (seg_pts[:, 0] > 0.5).astype(np.int64) + (seg_pts[:, 1] > 0.7)
    hg = rng.rand(50, 3)
    for max_dist in (None, 0.05):
        np.testing.assert_array_equal(
            TPr.fuse_part_ranks(hg, seg_pts, seg_rank, max_dist),
            JPr.fuse_part_ranks(hg, seg_pts, seg_rank, max_dist))
    part_rank = JPr.fuse_part_ranks(hg, seg_pts, seg_rank)
    grad_rank = rng.permutation(50).astype(np.int64)
    for kw in (dict(quota=8, per_part=3), dict(quota=20, per_part=2,
                                               min_spacing=0.2)):
        got = TPr.propose_touches(hg, part_rank, grad_rank, **kw)
        want = JPr.propose_touches(hg, part_rank, grad_rank, **kw)
        for f in ("points", "part_rank", "grad_rank"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_static_part_provider():
    assert (TV.StaticPartProvider("bunny", ("ears",)).part_names()
            == TV.PartResponse(**vars(JV.StaticPartProvider(
                "bunny", ("ears",)).part_names())))
    assert TV.PART_PROMPT == JV.PART_PROMPT


# ------------------------------------------------- the flow and the CLI ----

def _sphere_files(tmp_path, half=0.6, n=24, r=0.4, n_hg=40, seed=0,
                  hg_scale=0.05, hg_center=(0.4, 0, 0)):
    """The sphere mesh and high-grad cloud of tests/test_touch_select.py."""
    from fusionsense_tpu.mesh.marching import marching_tetrahedra
    from fusionsense_tpu.utils.ply import write_pcd, write_ply

    xs = np.linspace(-half, half, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = np.sqrt(gx**2 + gy**2 + gz**2) - r
    verts, faces = marching_tetrahedra(sdf, 0.0, (-half,) * 3, xs[1] - xs[0])
    write_ply(tmp_path / "mesh.ply", verts, faces=faces)
    hg = (np.random.RandomState(seed).randn(n_hg, 3).astype(np.float32)
          * hg_scale + hg_center)
    write_pcd(tmp_path / "hg.pcd", hg,
              extra={"grad_rank": np.arange(n_hg, dtype=np.float32)})
    return tmp_path / "mesh.ply", tmp_path / "hg.pcd"


def test_next_best_touches_matches_jax(tmp_path):
    from fusionsense_tpu.touch_select.select import next_best_touches as jnbt
    from fusionsense_tpu_torch.touch_select.select import next_best_touches

    mesh, hg = _sphere_files(tmp_path)
    want = jnbt(mesh, hg, quota=5, out_path=tmp_path / "jax.pcd")
    got = next_best_touches(mesh, hg, quota=5, out_path=tmp_path / "port.pcd",
                            device="cpu")
    np.testing.assert_array_equal(got.seg_points, want.seg_points)
    np.testing.assert_array_equal(got.seg_part_idx, want.seg_part_idx)
    for f in ("points", "part_rank", "grad_rank"):
        np.testing.assert_array_equal(getattr(got.proposals, f),
                                      getattr(want.proposals, f))
    assert ((tmp_path / "port.pcd").read_bytes()
            == (tmp_path / "jax.pcd").read_bytes())


def test_next_best_touches_segments_a_coloured_cloud(tmp_path):
    """A coloured point cloud (no faces: its points and colours are used
    as they are) through the fixture detector: the parts rank the
    proposals."""
    from fusionsense_tpu.touch_select.select import next_best_touches as jnbt
    from fusionsense_tpu.utils.ply import write_pcd, write_ply
    from fusionsense_tpu_torch.touch_select.select import next_best_touches

    pts, cols = two_blob_cloud()
    write_ply(tmp_path / "cloud.ply", pts, colors=cols)
    hg = pts[::9] + 0.01
    write_pcd(tmp_path / "hg.pcd", hg, extra={
        "grad_rank": np.arange(len(hg), dtype=np.float32)[::-1].copy()})
    kw = dict(quota=6, per_part=2, n_views=6, render_size=160)
    parts = JV.StaticPartProvider(parts=("red part", "blue part"))
    want = jnbt(tmp_path / "cloud.ply", tmp_path / "hg.pcd",
                part_provider=parts, detector=GeometricDetector(), **kw)
    got = next_best_touches(
        tmp_path / "cloud.ply", tmp_path / "hg.pcd",
        part_provider=TV.StaticPartProvider(parts=("red part", "blue part")),
        detector=PortGeometricDetector(), device="cpu", **kw)
    np.testing.assert_array_equal(got.seg_part_idx, want.seg_part_idx)
    assert set(np.unique(want.seg_part_idx)) >= {0, 1}
    for f in ("points", "part_rank", "grad_rank"):
        np.testing.assert_array_equal(getattr(got.proposals, f),
                                      getattr(want.proposals, f))


def test_fs_touch_matches_jax(tmp_path, capsys):
    from fusionsense_tpu.cli.touch import main as jmain
    from fusionsense_tpu_torch.cli.touch import main

    mesh, hg = _sphere_files(tmp_path, half=0.5, n=16, r=0.3, n_hg=20,
                             hg_scale=0.1, hg_center=(0, 0, 0))
    args = ["--mode", "touch", "--mesh", str(mesh), "--high-grad", str(hg),
            "--offline", "--quota", "3"]
    jmain(args + ["--output", str(tmp_path / "jax.pcd")])
    want = capsys.readouterr().out
    main(args + ["--output", str(tmp_path / "port.pcd")], device="cpu")
    got = capsys.readouterr().out
    assert got.replace("port.pcd", "jax.pcd") == want
    assert "touch 2" in got
    assert ((tmp_path / "port.pcd").read_bytes()
            == (tmp_path / "jax.pcd").read_bytes())
    jmain(["--mode", "partname", "--parts", "lid", "spout"])
    want = capsys.readouterr().out
    main(["--mode", "partname", "--parts", "lid", "spout"], device="cpu")
    assert capsys.readouterr().out == want


def test_fs_touch_flags_match_jax():
    from fusionsense_tpu.cli.touch import build_parser as jparser
    from fusionsense_tpu_torch.cli.touch import build_parser

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                         a.nargs, a.type, type(a).__name__)
                for a in p._actions}
    assert flags(build_parser()) == flags(jparser())
