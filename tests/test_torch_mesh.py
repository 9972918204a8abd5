"""The port's mesh modules against the JAX package's, on the CPU with the
same seeded numpy inputs: marching tetrahedra (torch in float64 against
host numpy), dense TSDF fusion and extraction, the sparse brick-hash TSDF,
post-processing, FFT Poisson, the level-set surface in its three level
modes and two normal modes, and the density grid."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from fusionsense_tpu.data.synthetic import ring_cameras as ring_j
from fusionsense_tpu.data.synthetic import sphere_depth_normals as sdn_j
from fusionsense_tpu.mesh import level_set as LSJ
from fusionsense_tpu.mesh import marching as MJ
from fusionsense_tpu.mesh import poisson as PJ
from fusionsense_tpu.mesh import postprocess as PPJ
from fusionsense_tpu.mesh import tsdf as TJ
from fusionsense_tpu.mesh import tsdf_sparse as TSJ
from fusionsense_tpu_torch.data.synthetic import ring_cameras as ring_t
from fusionsense_tpu_torch.mesh import level_set as LST
from fusionsense_tpu_torch.mesh import marching as MT
from fusionsense_tpu_torch.mesh import poisson as PT
from fusionsense_tpu_torch.mesh import postprocess as PPT
from fusionsense_tpu_torch.mesh import tsdf as TT
from fusionsense_tpu_torch.mesh import tsdf_sparse as TST

from mesh_match import assert_same_mesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops on a shared CPU run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_field(res=24, seed=0):
    """A noisy sphere SDF on [-1, 1]^3: crossings in every case."""
    g = np.linspace(-1.0, 1.0, res)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    rng = np.random.RandomState(seed)
    return (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6
            + 0.05 * rng.randn(*X.shape)), 2.0 / (res - 1)


# ------------------------------------------------------------ marching ----

@pytest.mark.parametrize("weld", [True, False])
def test_marching_matches_numpy(weld):
    """The same vertices and faces, not only the same surface: faces equal,
    vertices within 1e-9 (float64 throughout, float32 out)."""
    f, sp = _sphere_field()
    vj, fj = MJ.marching_tetrahedra(f, iso=0.0, origin=(-1, -1, -1),
                                    spacing=sp, weld=weld)
    vt, ft = MT.marching_tetrahedra(torch.tensor(f), iso=0.0,
                                    origin=(-1, -1, -1), spacing=sp, weld=weld)
    assert len(fj) > 1000 and vt.dtype == np.float32 and ft.dtype == np.int64
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(MT.vertex_normals(vt, ft),
                               MJ.vertex_normals(vj, fj), atol=1e-6)


def test_marching_empty_field():
    for f in (np.ones((6, 6, 6)), -np.ones((6, 6, 6))):
        vt, ft = MT.marching_tetrahedra(f)
        vj, fj = MJ.marching_tetrahedra(f)
        assert vt.shape == vj.shape == (0, 3) and ft.shape == fj.shape == (0, 3)
        assert vt.dtype == np.float32 and ft.dtype == np.int64


# ---------------------------------------------------------------- TSDF ----

def _views(n=3, w=64, h=48):
    cj = ring_j(n_views=n, width=w, height_px=h, focal=55.0, radius=1.6,
                height=0.5)
    ct = ring_t(n_views=n, width=w, height_px=h, focal=55.0, radius=1.6,
                height=0.5, device="cpu")
    depths = np.stack([np.asarray(sdn_j(cj.index(i), radius=0.35)[0])
                       for i in range(n)])
    return cj, ct, depths


def test_tsdf_matches_jax():
    """integrate_view, fuse_depths and extract_mesh on 32^3 with 3 views at
    64x48: the grids within 1e-5, the same mesh (mesh_match.py) with its
    vertices within 1e-5 and at most 0.1% of its faces reversed."""
    cj, ct, depths = _views()
    cfg_kw = dict(voxel_size=0.04, truncation=0.12, min_weight=1.0,
                  resolution=(32, 32, 32), origin=(-0.64, -0.64, -0.64))
    cfg_j, cfg_t = TJ.TSDFConfig(**cfg_kw, chunk=2 ** 12), TT.TSDFConfig(**cfg_kw)
    np.testing.assert_allclose(TT.voxel_centers(cfg_t).numpy(),
                               np.asarray(TJ.voxel_centers(cfg_j)), atol=1e-7)
    ts_j, w_j = TJ.fuse_depths(jnp.asarray(depths), cj, cfg_j)
    ts_t, w_t = TT.fuse_depths(torch.tensor(depths), ct, cfg_t)
    assert ts_t.shape == (32, 32, 32) and float(w_t.max()) == 3.0
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=1e-5)
    vj, fj = TJ.extract_mesh(ts_j, w_j, cfg_j)
    vt, ft = TT.extract_mesh(ts_t, w_t, cfg_t)
    assert len(fj) > 500
    assert_same_mesh(vt, ft, vj, fj, atol=1e-5, reversed_frac=1e-3)


def test_tsdf_refuses_a_room_scale_grid():
    cfg = TT.TSDFConfig(resolution=(1024, 1024, 256))
    with pytest.raises(ValueError, match="tsdf_sparse"):
        TT.fuse_depths(torch.zeros((1, 4, 4)), None, cfg)


def test_sparse_tsdf_matches_jax():
    """The brick-hash volume (a copy, marching through the port's marching
    tetrahedra): the same voxels, values and mesh."""
    cj, ct, depths = _views(n=4)
    cfg_kw = dict(voxel_size=0.03, truncation=0.09, min_weight=2.0, brick=8)
    vol_j = TSJ.fuse_depths_sparse(depths, cj, TSJ.SparseTSDFConfig(**cfg_kw))
    vol_t = TST.fuse_depths_sparse(torch.tensor(depths), ct,
                                   TST.SparseTSDFConfig(**cfg_kw))
    np.testing.assert_array_equal(vol_t.keys, vol_j.keys)
    np.testing.assert_array_equal(vol_t.tsdf, vol_j.tsdf)
    np.testing.assert_array_equal(vol_t.weight, vol_j.weight)
    vj, fj = vol_j.extract_mesh()
    vt, ft = vol_t.extract_mesh()
    assert len(fj) > 200
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, vj)


# ---------------------------------------------------------- postprocess ----

def test_postprocess_matches_jax():
    f, sp = _sphere_field(res=16)
    v, fa = MJ.marching_tetrahedra(f, origin=(-1, -1, -1), spacing=sp)
    np.testing.assert_array_equal(PPT.laplacian_smooth(v, fa, iterations=3),
                                  PPJ.laplacian_smooth(v, fa, iterations=3))
    for a, b in zip(PPT.decimate_vertex_clustering(v, fa, 0.2),
                    PPJ.decimate_vertex_clustering(v, fa, 0.2)):
        np.testing.assert_array_equal(a, b)
    depth = np.random.RandomState(0).uniform(0.5, 2.0, (48, 64)).astype(
        np.float32)
    depth[10:30, 20:40] = 1.0
    np.testing.assert_array_equal(PPT.find_depth_edges(depth, dilate=2),
                                  PPJ.find_depth_edges(depth, dilate=2))


# -------------------------------------------------------------- Poisson ----

def _oriented_sphere(n=1500, r=0.4, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (r * d + 0.002 * rng.normal(size=(n, 3))).astype(np.float32), d


def test_poisson_matches_jax():
    """At resolution 32: the scattered field and chi within rtol 1e-4 of
    their scale, the mesh within half a voxel of JAX's (chamfer both ways;
    the scatter-add's order, and so chi's last bits, differ)."""
    pts, nrm = _oriented_sphere()
    cfg_j, cfg_t = PJ.PoissonConfig(resolution=32), PT.PoissonConfig(
        resolution=32)
    gp = (pts - pts.min(0) + 0.1) / 0.03
    field_j = np.asarray(PJ._scatter_field(jnp.asarray(gp), jnp.asarray(
        nrm, jnp.float32), 32))
    field_t = PT._scatter_field(torch.tensor(gp), torch.tensor(
        nrm, dtype=torch.float32), 32)
    np.testing.assert_allclose(field_t.numpy(), field_j,
                               atol=1e-4 * np.abs(field_j).max())
    chi_j = np.asarray(PJ._solve(jnp.asarray(field_j), 1.5))
    chi_t = PT._solve(torch.tensor(field_j), 1.5).numpy()
    np.testing.assert_allclose(chi_t, chi_j, atol=1e-4 * np.abs(chi_j).max())
    vj, fj = PJ.poisson_reconstruct(pts, nrm, cfg_j)
    vt, ft = PT.poisson_reconstruct(pts, nrm, cfg_t, device="cpu")
    assert len(fj) > 500 and abs(len(ft) - len(fj)) <= 0.01 * len(fj)
    ext = float((pts.max(0) - pts.min(0)).max())
    voxel = ext * (1 + 2 * cfg_t.padding) / (cfg_t.resolution - 1)
    for a, b in ((vt, vj), (vj, vt)):
        assert cKDTree(b).query(a)[0].max() <= 0.5 * voxel


# ------------------------------------------------------------ level set ----

def _gauss_scene(n=200, seed=0):
    """200 Gaussians in a shell 2 m in front of an identity camera, a few
    dead; random (distinct) positions, so the KNN has no ties."""
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = (np.array([0.0, 0.0, 2.0]) + 0.5 * d).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(0.03, 0.09, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[rng.choice(n, 10, replace=False)] = False
    gn = rng.normal(size=(n, 3)).astype(np.float32)
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    # a depth map on the shell's front, a margin left empty
    H, W = 48, 64
    ys, xs = np.mgrid[0:H, 0:W]
    depth = (1.55 + 0.1 * np.sin(xs / 9.0) * np.cos(ys / 7.0)).astype(
        np.float32)
    depth[:4] = 0.0
    return [means, quats, scales, opac, alive, gn], depth


@pytest.mark.parametrize("level_mode", ["absolute", "relative", "peak"])
@pytest.mark.parametrize("normal_mode", ["closest_gaussian", "analytical"])
def test_level_surface_matches_jax(level_mode, normal_mode):
    """The valid masks equal but for pixels whose density sample sits
    within float32 noise of the level (at most 1%), and the points and
    normals of the others within 1e-4 (the analytical normals, scaled by
    one matrix norm of the whole gradient in both packages, within 1e-4
    of their largest entry)."""
    g, depth = _gauss_scene()
    K = np.array([[55.0, 0, 32.0], [0, 55.0, 24.0]], np.float32)
    vm = np.eye(4, dtype=np.float32)
    kw = dict(width=64, height=48, level=0.3, chunk=1024, n_samples=11,
              level_mode=level_mode, normal_mode=normal_mode)
    pj, nj, vj = LSJ.level_surface_from_depth(
        jnp.asarray(depth), jnp.asarray(vm), K[0, 0], K[1, 1], K[0, 2],
        K[1, 2], *[jnp.asarray(a) for a in g], **kw)
    pt, nt, vt = LST.level_surface_from_depth(
        torch.tensor(depth), torch.tensor(vm), float(K[0, 0]), float(K[1, 1]),
        float(K[0, 2]), float(K[1, 2]), *[torch.tensor(a) for a in g], **kw)
    pj, nj, vj = np.asarray(pj), np.asarray(nj), np.asarray(vj)
    pt, nt, vt = pt.numpy(), nt.numpy(), vt.numpy()
    assert vj.sum() > 500
    assert (vt != vj).sum() <= 0.01 * vj.size
    both = vt & vj
    close = np.abs(pt - pj).max(1) <= 1e-4
    assert close[both].mean() >= 0.99
    np.testing.assert_allclose(nt[both & close], nj[both & close],
                               atol=1e-4 * np.abs(nj).max())


def test_density_grid_matches_jax():
    g, _ = _gauss_scene()
    kw = dict(origin=(-0.6, -0.6, 1.4), voxel_size=0.075,
              resolution=(16, 16, 16), k=8, chunk=512)
    dj = np.asarray(LSJ.density_grid(*[jnp.asarray(a) for a in g[:5]], **kw))
    dt = LST.density_grid(*[torch.tensor(a) for a in g[:5]], **kw).numpy()
    assert dt.shape == (16, 16, 16) and dj.max() > 0.5
    np.testing.assert_allclose(dt, dj, atol=1e-5, rtol=1e-5)
