"""The port's mesh export front-end against the JAX package's, on one 64x48
blob capture: fs-mesh on a port checkpoint for each of the five methods
against JAX's mesh_export.extract on the same Gaussians (the `jax`
backend), the PLY files each writes, pipeline.extract_mesh with camera-opt
pose deltas, fs-train with its default --mesh, and fs-eval with a chamfer
against a GT mesh. The grids are cut to 32 (the marching and TSDF
resolution, and the Poisson grid through a partial of extract) to keep
the CPU's share small."""
import dataclasses
import functools
import json
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import fusionsense_tpu_torch.mesh_export as MET
import fusionsense_tpu_torch.pipeline as PIPET
from fusionsense_tpu import mesh_export as MEJ
from fusionsense_tpu.cli import eval as CLIEJ
from fusionsense_tpu.cli import mesh as CLIMJ
from fusionsense_tpu.data import dataparser as DPJ
from fusionsense_tpu.eval import chamfer as CHJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.gaussians.store import GaussianState as GSJ
from fusionsense_tpu.mesh.poisson import PoissonConfig as PCJ
from fusionsense_tpu.render.rasterize import RasterizeConfig as RCJ
from fusionsense_tpu_torch import config as CFT
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.cli import eval as CLIE
from fusionsense_tpu_torch.cli import mesh as CLIM
from fusionsense_tpu_torch.cli import train as CLIT
from fusionsense_tpu_torch.data import dataparser as DPT
from fusionsense_tpu_torch.data.fixture import write_blob_scene
from fusionsense_tpu_torch.eval import evaluator as EVT
from fusionsense_tpu_torch.gaussians.adc import init_stats
from fusionsense_tpu_torch.mesh.poisson import PoissonConfig as PCT
from fusionsense_tpu_torch.priors import visual_hull as VHT
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from fusionsense_tpu_torch.train.checkpoint import save_checkpoint
from fusionsense_tpu_torch.train.optim import init_adam
from fusionsense_tpu_torch.utils.ply import read_ply, write_ply

from mesh_match import assert_same_mesh

W, H, V = 64, 48, 5
RES = 32
VERT_ATOL = 1e-4       # capture coordinates; the renders agree to ~1e-5
POISSON_ATOL = 0.01    # of a Poisson voxel: chi's last bits differ
REVERSED = 1e-3        # faces whose orientation test is float32 noise


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops on a shared CPU run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_grids(monkeypatch):
    """extract with the Poisson grid at RES wherever it is reached from."""
    monkeypatch.setattr(MET, "extract", functools.partial(
        MET.extract, poisson=PCT(resolution=RES)))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The blob capture, both packages' parse of its train split, and one
    Gaussian state (a JAX init from the scene's seed cloud) as numpy and
    as a port checkpoint."""
    root = tmp_path_factory.mktemp("export")
    scene = root / "scene"
    write_blob_scene(scene, n_views=V, width=W, height=H, focal=55.0,
                     n_gt=800, n_seed_pts=300, device="cpu")
    cfg_j = DPJ.DataParserConfig(data_dir=str(scene))
    cfg_t = DPT.DataParserConfig(data_dir=str(scene))
    sj, st = DPJ.parse_transforms(cfg_j), DPT.parse_transforms(cfg_t, "cpu")
    init = init_j(jnp.asarray(sj.seed_points), jnp.asarray(sj.seed_colors),
                  capacity=1024, sh_degree=1)
    state = {k: np.asarray(v) for k, v in dataclasses.asdict(init).items()}
    g = convert.state_from_numpy(state, "cpu")
    ckpt = root / "run" / "ckpt_7"
    save_checkpoint(ckpt, g, init_adam(g.params()), init_stats(g.capacity, "cpu"),
                    7)
    return dict(scene=scene, sj=sj, st=st,
                cam_j=DPJ.load_train_data(sj, cfg_j)[0],
                cam_t=DPT.load_train_data(st, cfg_t)[0], state=state,
                ckpt=ckpt)


def _gj(state):
    return GSJ(**{k: jnp.asarray(v) for k, v in state.items()})


def _jax_extract(cap, method, out, rcfg=None, state=None, **kw):
    return MEJ.extract(method, _gj(state or cap["state"]), cap["cam_j"],
                       rcfg or RCJ(backend="jax"), out,
                       untransform=cap["sj"].untransform_points,
                       hull_points=cap["sj"].hull_points, resolution=RES,
                       poisson=PCJ(resolution=RES), **kw)


def _assert_matches(method, got, want, dirs):
    """The port's mesh against JAX's: the same mesh (mesh_match.py), its
    vertices within VERT_ATOL for the grid methods and within 1% of a
    Poisson voxel (about the mesh's extent / RES) for the Poisson ones.
    sugar-coarse's level-set samples sit on density crossings, a few of
    which float32 noise moves by a sample: its clouds agree on 99% of the
    points within 1e-5 and its Poisson meshes within half a voxel."""
    vt, ft, _ = got
    vj, fj, _ = want
    assert len(fj) > 200
    voxel = float(np.ptp(vj, 0).max()) / (RES - 1)
    if method in ("tsdf", "marching"):
        assert_same_mesh(vt, ft, vj, fj, atol=VERT_ATOL, reversed_frac=REVERSED)
        return
    if method != "sugar-coarse":
        assert_same_mesh(vt, ft, vj, fj, atol=POISSON_ATOL * voxel,
                         reversed_frac=REVERSED)
        return
    name = "after_clean_points_surface_level_0.3.ply"
    pt, pj = (read_ply(d / name) for d in dirs)
    assert pt["points"].shape == pj["points"].shape
    close = np.abs(pt["points"] - pj["points"]).max(1) <= 1e-5
    assert close.mean() >= 0.99
    assert abs(len(ft) - len(fj)) <= 0.02 * len(fj)
    for a, b in ((vt, vj), (vj, vt)):
        assert np.mean(cKDTree(b).query(a)[0]) <= 0.5 * voxel


def _actions(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.required, a.const,
                     a.type) for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax_cli", [(CLIM, CLIMJ), (CLIE, CLIEJ)],
                         ids=["fs-mesh", "fs-eval"])
def test_cli_parsers_match_jax(port, jax_cli):
    """The JAX CLIs' flags, dests, defaults, choices and types."""
    assert _actions(port.build_parser()) == _actions(jax_cli.build_parser())


@pytest.mark.parametrize("method", MET.METHODS)
def test_fs_mesh_matches_jax_extract(capture, tmp_path, method):
    """fs-mesh on the port checkpoint (backend jax, tile capacity 512, the
    CLI's defaults) against JAX's extract on the same Gaussians; both
    write the same PLY files, which read back as the returned mesh."""
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    (got,) = CLIM.main([method, "--checkpoint", str(capture["ckpt"]),
                        "--data", str(capture["scene"]), "--output-dir",
                        str(out_t), "--resolution", str(RES)], device="cpu")
    want = _jax_extract(capture, method, out_j,
                        rcfg=RCJ(tile_capacity=512, backend="jax"))
    _assert_matches(method, got, want, (out_t, out_j))
    assert got[2].name == want[2].name
    assert sorted(p.name for p in out_t.iterdir()) == sorted(
        p.name for p in out_j.iterdir())
    ply = read_ply(got[2])
    np.testing.assert_array_equal(ply["points"], got[0])
    np.testing.assert_array_equal(ply["faces"], got[1])


def test_pipeline_extract_mesh_takes_the_trainer_state(capture, tmp_path):
    """pipeline.extract_mesh: the trainer's Gaussians, its camera-opt pose
    deltas, its grown tile capacity and the pipeline's hull, as JAX's
    pipeline passes them to extract."""
    rc = RCT(tile_size=16, tile_capacity=128, max_tiles_per_gaussian=16,
             sh_degree=1)
    cfg = PIPET.PipelineConfig(
        data=DPT.DataParserConfig(data_dir=str(capture["scene"])),
        experiment=CFT.ExperimentConfig(
            model=CFT.ModelConfig(sh_degree=1, capacity=1024, rasterize=rc),
            train=CFT.TrainConfig(camera_opt=True)),
        output_dir=str(tmp_path / "t"))
    pipe = PIPET.ReconstructionPipeline(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="train first"):
        pipe.extract_mesh("tsdf")
    deltas = 0.01 * np.random.RandomState(0).normal(size=(V - 1, 6))
    pipe.trainer = types.SimpleNamespace(
        gaussians=convert.state_from_numpy(capture["state"], "cpu"),
        cam_state=(torch.tensor(deltas, dtype=torch.float32), None),
        tile_capacity=256)
    pipe.hull_points = capture["st"].hull_points
    got = pipe.extract_mesh("tsdf", resolution=RES)
    want = _jax_extract(capture, "tsdf", tmp_path / "j",
                        rcfg=RCJ(**{**dataclasses.asdict(rc),
                                    "tile_capacity": 256}),
                        cam_deltas=deltas.astype(np.float32))
    _assert_matches("tsdf", got, want, None)
    assert got[2] == tmp_path / "t" / "mesh_tsdf.ply"
    # the deltas moved the mesh: without them it is another one
    plain = _jax_extract(capture, "tsdf", tmp_path / "p")
    assert plain[0].shape != got[0].shape or np.abs(plain[0] - got[0]).max() > 1e-3


def test_fs_train_extracts_its_default_meshes(capture, tmp_path, monkeypatch):
    """fs-train in the port with its default --mesh (tsdf sugar-coarse)
    after 4 steps: both meshes, the level-set cloud and the smoothed
    variants land in the output directory; the tsdf mesh is JAX's extract
    of the trained Gaussians."""
    monkeypatch.setattr(PIPET, "visual_hull", functools.partial(
        VHT.visual_hull, cfg=VHT.VisualHullConfig(voxel_size=0.02)))
    monkeypatch.setattr(MET, "extract", functools.partial(
        MET.extract, resolution=RES, poisson=PCT(resolution=RES)))
    shutil.copytree(capture["scene"], tmp_path / "scene")
    pipe = CLIT.main([
        "--data", str(tmp_path / "scene"), "--output-dir", str(tmp_path / "o"),
        "--iterations", "4", "--scan-chunk", "4", "--warmup-length", "4",
        "--stop-split-at", "504", "--capacity", "4096", "--sh-degree", "1",
        "--tile-capacity", "256", "--skip-eval"], device="cpu")
    out = tmp_path / "o" / "dn_splatter"
    names = {p.name for p in out.glob("*.ply")}
    for f in ("mesh_tsdf.ply", "mesh_sugar-coarse_level_0.3.ply",
              "smoothed_1_mesh_sugar-coarse_level_0.3.ply",
              "smoothed_2_mesh_sugar-coarse_level_0.3.ply",
              "after_clean_points_surface_level_0.3.ply"):
        assert f in names, f
    got = read_ply(out / "mesh_tsdf.ply")
    g = pipe.trainer.gaussians
    state = {k: v.numpy() for k, v in g.fields().items()}
    sj = DPJ.parse_transforms(DPJ.DataParserConfig(data_dir=str(tmp_path / "scene")))
    cam_j = DPJ.load_train_data(sj, DPJ.DataParserConfig(
        data_dir=str(tmp_path / "scene")))[0]
    rc = pipe._render_rcfg()
    vj, fj, _ = MEJ.extract("tsdf", _gj(state), cam_j,
                            RCJ(**dataclasses.asdict(rc)), tmp_path / "j",
                            untransform=sj.untransform_points,
                            hull_points=pipe.hull_points, resolution=RES)
    assert_same_mesh(got["points"], got["faces"], vj, fj, atol=VERT_ATOL,
                     reversed_frac=REVERSED)


def test_fs_eval_on_a_port_checkpoint(capture, tmp_path):
    """fs-eval: the render metrics of evaluate on the same Gaussians at the
    checkpoint's SH degree, 1 (tests/test_torch_pipeline.py holds evaluate
    to JAX's), and the chamfer of a mesh against a GT cloud in mm equal to
    JAX's chamfer_eval."""
    mesh = tmp_path / "mesh.ply"
    vt, ft, _ = MET.extract("gaussians", convert.state_from_numpy(
        capture["state"], "cpu"), capture["cam_t"], RCT(backend="jax"),
        tmp_path / "m")
    write_ply(mesh, vt, faces=ft)
    rng = np.random.RandomState(0)
    d = rng.normal(size=(2000, 3))
    gt = 1e3 * 0.4 * d / np.linalg.norm(d, axis=1, keepdims=True)
    write_ply(tmp_path / "gt.ply", gt)
    res = CLIE.main(["--checkpoint", str(capture["ckpt"]), "--data",
                     str(capture["scene"]), "--output-path",
                     str(tmp_path / "m.json"), "--gt-mesh",
                     str(tmp_path / "gt.ply"), "--pred-mesh", str(mesh)],
                    device="cpu")
    assert json.loads((tmp_path / "m.json").read_text())["step"] == res["step"] == 7
    want = EVT.evaluate(convert.state_from_numpy(capture["state"], "cpu"),
                        capture["cam_t"], DPT.load_train_data(
                            capture["st"], DPT.DataParserConfig(
                                data_dir=str(capture["scene"])))[1],
                        RCT(backend="jax", sh_degree=1), measure_fps=False)
    assert set(want["mean"]) < set(res["mean"])
    for k, v in want["mean"].items():
        assert res["mean"][k] == v, k
    cj = CHJ.chamfer_eval(read_ply(mesh)["points"],
                          read_ply(tmp_path / "gt.ply")["points"],
                          gt_unit_scale=1e-3)
    assert set(res["chamfer"]) == set(cj)
    for k in cj:
        np.testing.assert_allclose(res["chamfer"][k], cj[k], rtol=1e-6)
