"""The port's live splat viewer (viewer/server.py, viewer.html), its
ViewerCallback on Trainer.run and fs-viewer (cli/viewer.py), on the CPU,
against the JAX package's: the .splat bytes of the same state equal byte
for byte, the HTTP contract of tests/test_viewer.py on an ephemeral port,
the same HTML, and the same fs-viewer flags."""
import argparse
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.cli import viewer as CLIJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.viewer import server as VJ
from fusionsense_tpu_torch import config as CFT
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.cli import viewer as CLIT
from fusionsense_tpu_torch.data.synthetic import (
    ring_cameras, sphere_depth_normals, sphere_points,
)
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.gaussians.io import export_splat_ply
from fusionsense_tpu_torch.gaussians.store import PARAM_KEYS
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
from fusionsense_tpu_torch.train.trainer import Trainer, TrainData
from fusionsense_tpu_torch.viewer import server as VT


def _get(url):
    return urllib.request.urlopen(url, timeout=30).read()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_state(n=40, capacity=64, seed=0):
    """A JAX GaussianState with random fields (a third of the slots dead,
    opacities and colours on and around their rounding edges) and its
    fields as numpy."""
    rng = np.random.default_rng(seed)
    g = init_j(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
               jnp.full((n, 3), 0.5), capacity=capacity, sh_degree=1)
    c = capacity
    f = {"means": rng.normal(size=(c, 3)),
         "log_scales": rng.normal(-3, 1, size=(c, 3)),
         "logit_opacities": np.concatenate([[0.0, -40.0, 40.0],
                                            rng.normal(0, 3, size=c - 3)]),
         "quats": rng.normal(size=(c, 4)),
         "features_dc": np.concatenate([[[1.7724539, -1.7724539, 0.0]],
                                        rng.normal(0, 2, size=(c - 1, 3))])}
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    f["alive"] = rng.uniform(size=c) > 0.33
    g = g.replace(**{k: jnp.asarray(v) for k, v in f.items()})
    return g, {k: np.asarray(getattr(g, k))
               for k in (*PARAM_KEYS, "alive", "frozen")}


@pytest.mark.parametrize("max_splats", [None, 10, 1000])
def test_pack_state_bytes_equal_jax(max_splats):
    g, fields = _random_state()
    want = VJ.pack_state(g, max_splats)
    got = VT.pack_state(convert.state_from_numpy(fields, "cpu"), max_splats)
    n_alive = int(fields["alive"].sum())
    assert len(got) == 32 * min(n_alive, max_splats or n_alive)
    assert got == want


def test_pack_splats_bytes_equal_jax():
    rng = np.random.default_rng(1)
    n = 50
    args = (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32),
            rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))
    for m in (None, 7):
        assert VT.pack_splats(*args, max_splats=m) == VJ.pack_splats(
            *args, max_splats=m)


def test_http_contract_and_page():
    """tests/test_viewer.py's contract on the port's server; / serves the
    JAX package's viewer.html byte for byte."""
    srv = VT.SplatViewerServer(port=0)
    try:
        blob = VT.pack_splats(
            np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32) * 0.1,
            np.ones((3, 3), np.float32), np.ones(3, np.float32) * 0.9,
            np.tile(np.array([1, 0, 0, 0], np.float32), (3, 1)))
        srv.update(blob, step=42, metrics={"psnr": 21.5})

        html = _get(srv.url)
        assert html == (Path(VJ.__file__).parent / "viewer.html").read_bytes()
        assert b"webgl2" in html.lower()
        assert _get(srv.url + "index.html") == html

        st = json.loads(_get(srv.url + "state"))
        assert st["step"] == 42 and st["num_splats"] == 3
        assert st["metrics"]["psnr"] == 21.5
        v0 = st["version"]
        assert _get(srv.url + "splats.bin") == blob

        srv.update(blob + blob, step=43)
        st = json.loads(_get(srv.url + "state"))
        assert st["version"] == v0 + 1 and st["num_splats"] == 6
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.url + "nothing")
    finally:
        srv.close()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 6-step CPU Trainer.run (chunks of 2) with a ViewerCallback on a
    server at port 0, snapshotting every 2 steps; the served state after
    each chunk is recorded by a callback behind it."""
    V, W, H = 3, 32, 24
    cams = ring_cameras(n_views=V, width=W, height_px=H, focal=30.0,
                        device="cpu")
    dn = [sphere_depth_normals(cams.index(i)) for i in range(V)]
    normals = torch.stack([d[1] for d in dn])
    data = TrainData(images=torch.clamp(0.5 + 0.5 * normals, 0, 1),
                     sensor_depths=torch.stack([d[0] for d in dn]),
                     normals=normals)
    pts, rgb, nrm = sphere_points(n=200, radius=0.5, device="cpu")
    init = init_from_points(pts, rgb, capacity=512, sh_degree=1,
                            seed_normals=nrm,
                            generator=torch.Generator().manual_seed(0))
    cfg = CFT.ExperimentConfig(
        model=CFT.ModelConfig(sh_degree=1, capacity=512,
                              binary_opacities=False,
                              rasterize=RasterizeConfig(
                                  tile_size=16, tile_capacity=128,
                                  sh_degree=1, backend="jax")),
        train=CFT.TrainConfig(iterations=6, scan_chunk=2, log_every=2))
    srv = VT.SplatViewerServer(port=0)
    cb = VT.ViewerCallback(srv, every=2)
    served, returned = [], []

    def record(tr):
        returned.append(cb(tr))
        st = json.loads(_get(srv.url + "state"))
        served.append((tr.step, st, _get(srv.url + "splats.bin"),
                       VT.pack_state(tr.gaussians, 400_000)))

    tr = Trainer(cfg, cams, data, init, extra_callbacks=[record],
                 device="cpu")
    try:
        tr.run(log=None)
    finally:
        srv.close()
    ckpt = tmp_path_factory.mktemp("viewer") / "ckpt_6"
    tr.save(ckpt)
    return tr, served, returned, ckpt


def test_viewer_callback_snapshots_trainer_run(trained):
    tr, served, returned, _ = trained
    assert [s[0] for s in served] == [2, 4, 6]
    assert returned == [None, None, None]     # never marks the alive set
    for i, (step, st, blob, packed) in enumerate(served):
        assert st["step"] == step and st["version"] == i + 1
        assert blob == packed
        assert st["num_splats"] == len(blob) // 32
        # the callbacks run before the boundary's log record is kept, so
        # the served metrics are the previous record's, as in JAX
        assert st["metrics"] == (tr.history[i - 1] if i else {})
    assert served[-1][1]["num_splats"] == int(tr.gaussians.num_alive)


def _actions(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.required, a.const,
                     a.type) for a in parser._actions}


def test_fs_viewer_parser_matches_jax(monkeypatch):
    class Parsed(Exception):
        pass

    def grab(self, *a, **kw):
        raise Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed) as e:
            CLIJ.main([])
    jp, tp = e.value.args[0], CLIT.build_parser()
    assert tp.prog == jp.prog == "fs-viewer"
    assert _actions(tp) == _actions(jp)
    with pytest.raises(SystemExit):
        CLIT.main([], device="cpu")       # needs --ply or --checkpoint


@pytest.mark.parametrize("source", ["checkpoint", "ply"])
def test_fs_viewer_serves_a_model(trained, tmp_path, monkeypatch, capsys,
                                  source):
    """fs-viewer on the trained checkpoint and on its splat PLY: the URL
    line, the page, /state and /splats.bin; Ctrl-C closes the server."""
    tr, *_, ckpt = trained
    if source == "ply":
        path = tmp_path / "splat.ply"
        export_splat_ply(path, tr.gaussians)
    else:
        path = ckpt
    seen = {}

    def interrupt(_):
        line = capsys.readouterr().out.strip()
        url = line.rsplit(" at ", 1)[1]
        seen["line"] = line
        seen["page"] = _get(url)
        seen["state"] = json.loads(_get(url + "state"))
        seen["blob"] = _get(url + "splats.bin")
        raise KeyboardInterrupt

    monkeypatch.setattr(CLIT.time, "sleep", interrupt)
    CLIT.main([f"--{source}", str(path), "--port", "0"], device="cpu")
    n = int(tr.gaussians.num_alive)
    assert seen["line"].startswith(f"viewing {n} splats at http://127.0.0.1:")
    assert b"webgl2" in seen["page"].lower()
    assert seen["state"]["num_splats"] == n and seen["state"]["step"] == 0
    if source == "checkpoint":
        assert seen["blob"] == VT.pack_state(tr.gaussians, 400_000)
    else:
        assert len(seen["blob"]) == 32 * n
