"""End-to-end reconstruction pipeline, in-process.

Counterpart of fusionsense_tpu/pipeline.py. Stages:
 1. parse transforms.json and load the train split onto the device,
 2. the visual hull from the masks               [priors.visual_hull]
 3. the seed cloud from depths + hull             [priors.pcd_init]
 4. training with ADC, touch anchoring and the hull / touch pruning
    callbacks, debug image grids and periodic checkpoints,
 5. the high-gradient export for active touch     [touch_select.high_grad]
 6. mesh extraction                                [mesh_export]
 7. evaluation (render metrics) -> metrics.json.
Generated priors are written in capture coordinates and registered in the
scene's transforms.json, so later runs reuse them. With `viewer`, the live
splat viewer serves the model while Trainer.run trains it.

With `device_mesh` ("data=2,tile=2,gauss=2") the run trains on a mesh of
that many ranks, one process each (torchrun; parallel/): every rank reads
the scene and builds the priors, a ShardedTrainer starts every rank from
rank 0's state, and only rank 0 (`writer`) writes artifacts, checkpoints,
meshes, metrics.json and the log. The mesh is made before the scene is
read, so a mesh that does not fit the ranks raises first.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fusionsense_tpu_torch.config import ExperimentConfig
from fusionsense_tpu_torch.data.dataparser import (
    DataParserConfig, load_train_data, parse_transforms,
)
from fusionsense_tpu_torch.device import resolve_device
from fusionsense_tpu_torch.eval.evaluator import evaluate
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.gaussians.touch import (
    TouchBoxes, add_touch_patches, hull_prune, touch_prune,
)
from fusionsense_tpu_torch.priors.pcd_init import seed_pcd_from_depths
from fusionsense_tpu_torch.priors.visual_hull import visual_hull
from fusionsense_tpu_torch.touch_select.high_grad import export_high_grad_pcd
from fusionsense_tpu_torch.train.trainer import Trainer
from fusionsense_tpu_torch.utils.ply import write_ply


@dataclasses.dataclass
class PipelineConfig:
    data: DataParserConfig = dataclasses.field(default_factory=DataParserConfig)
    experiment: ExperimentConfig = dataclasses.field(
        default_factory=ExperimentConfig)
    gel_scale: float = 6.34e-5
    run_visual_hull: bool = True
    run_hull_pruning: bool = True
    high_grad_export: bool = True
    output_dir: str = "outputs"
    viewer: bool = False          # serve the live WebGL splat viewer
    viewer_port: int = 7007
    device_mesh: Optional[str] = None   # e.g. "data=2,tile=2,gauss=2"
    resume: Optional[str] = None  # a Trainer.save checkpoint to resume from


class ReconstructionPipeline:
    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.mesh = None
        if cfg.device_mesh:
            from fusionsense_tpu_torch.parallel.mesh import (
                make_mesh, parse_axes,
            )

            axes = parse_axes(cfg.device_mesh)
            n_dev = 1
            for v in axes.values():
                n_dev *= v
            self.mesh = make_mesh(n_dev, **axes, device=device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.writer = self.mesh is None or self.mesh.rank == 0
        self.out = Path(cfg.output_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.scene = parse_transforms(cfg.data, device=self.device)
        self.camera, self.data = load_train_data(self.scene, cfg.data, "train")
        if self.mesh is not None:
            # every rank has read transforms.json before rank 0 registers
            # generated priors in it
            torch.distributed.barrier()
        self.hull_points: Optional[np.ndarray] = None
        self.trainer = None
        self.viewer_server = None

    def _register_artifact(self, key: str, path):
        """Point transforms.json's `key` at a generated prior, so later runs
        reuse it (read-only datasets keep it in output_dir only)."""
        if not self.writer:
            return
        tj = Path(self.cfg.data.data_dir) / "transforms.json"
        try:
            with open(tj) as f:
                meta = json.load(f)
            meta[key] = str(Path(path).absolute())
            with open(tj, "w") as f:
                json.dump(meta, f)
        except OSError:
            pass

    # ---------------------------------------------------------- priors ----
    def build_priors(self):
        """-> (points, colors, normals or None) of the seed cloud, on the
        device; carves the hull first when the scene has masks and none."""
        cfg, scene, dev = self.cfg, self.scene, self.device
        if scene.hull_points is not None:
            self.hull_points = np.asarray(scene.hull_points)
        elif cfg.run_visual_hull and self.data.masks is not None:
            self.hull_points = visual_hull(self.data.masks, self.camera)
            # artifacts are stored in capture coordinates: the dataparser
            # re-applies the scene normalisation on load
            if self.writer:
                write_ply(self.out / "foreground_pcd.ply",
                          scene.untransform_points(self.hull_points))
            self._register_artifact("object_pc_path",
                                    self.out / "foreground_pcd.ply")

        on_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=dev)
        if scene.seed_points is not None:
            pts = on_dev(scene.seed_points)
            rgb = on_dev(scene.seed_colors if scene.seed_colors is not None
                         else np.full((len(pts), 3), 0.5, np.float32))
            normals = (on_dev(scene.seed_normals)
                       if scene.seed_normals is not None else None)
            return pts, rgb, normals
        depth_src = (self.data.sensor_depths
                     if self.data.sensor_depths is not None
                     else self.data.mono_depths)
        if depth_src is None:
            raise ValueError("the scene needs a seed cloud (ply_file_path) or "
                             "depth maps to initialise from")
        pts_np, rgb_np = seed_pcd_from_depths(depth_src, self.data.images,
                                              self.camera,
                                              hull_points=self.hull_points)
        if self.writer:
            write_ply(self.out / "merged_pcd.ply",
                      scene.untransform_points(pts_np), colors=rgb_np)
        self._register_artifact("ply_file_path", self.out / "merged_pcd.ply")
        return on_dev(pts_np), on_dev(rgb_np), None

    # ----------------------------------------------------------- train ----
    def _callbacks(self, state: dict, boxes_ref: dict, log) -> list:
        cfg = self.cfg
        ec = cfg.experiment
        callbacks = []
        if (self.hull_points is not None and len(self.hull_points)
                and cfg.run_hull_pruning):
            hull = torch.as_tensor(np.asarray(self.hull_points, np.float32),
                                   device=self.device)

            def hull_cb(tr):
                if tr.step >= ec.train.adc.warmup:
                    tr.gaussians = hull_prune(tr.gaussians, hull)
                    return True
                return False
            callbacks.append(hull_cb)

        if self.scene.touch_patches:
            def touch_cb(tr):
                if (not state["touch_added"]
                        and tr.step >= ec.train.add_touch_at):
                    tr.gaussians, tr.opt, boxes_ref["boxes"] = (
                        add_touch_patches(
                            tr.gaussians, tr.opt, self.scene.touch_patches,
                            gel_scale=cfg.gel_scale,
                            scene_scale=self.scene.scale))
                    state["touch_added"] = True
                    return True
                elif state["touch_added"]:
                    tr.gaussians = touch_prune(tr.gaussians,
                                               boxes_ref["boxes"])
                    return True
                return False
            callbacks.append(touch_cb)

        if cfg.high_grad_export and self.writer:
            def high_grad_cb(tr):
                target = ec.train.adc.stop_split_at - 500
                if not state["high_grad_done"] and tr.step >= target:
                    n = export_high_grad_pcd(
                        self.out / "high_grad_pts.pcd", tr.gaussians,
                        tr.stats, self.hull_points,
                        untransform=self.scene.untransform_points)
                    state["high_grad_done"] = True
                    if log:
                        log(f"high-grad export: {n} points")
            callbacks.append(high_grad_cb)

        if cfg.viewer and self.writer:
            from fusionsense_tpu_torch.viewer import (
                SplatViewerServer, ViewerCallback,
            )

            self.viewer_server = SplatViewerServer(port=cfg.viewer_port)
            callbacks.append(ViewerCallback(self.viewer_server))
            if log:
                log(f"live viewer at {self.viewer_server.url}")
        return callbacks

    def train(self, log=print):
        ec = self.cfg.experiment
        pts, rgb, normals = self.build_priors()
        capacity = ec.model.capacity
        if pts.shape[0] > capacity // 2:
            stride = pts.shape[0] // (capacity // 2) + 1
            pts, rgb = pts[::stride], rgb[::stride]
            normals = normals[::stride] if normals is not None else None
        # without seed normals the orientations are drawn from seed 0, as
        # the JAX pipeline draws them from PRNGKey(0)
        gaussians = init_from_points(
            pts, rgb, capacity=capacity, sh_degree=ec.model.sh_degree,
            seed_normals=normals, init_opacity=ec.model.init_opacity,
            generator=torch.Generator().manual_seed(0))

        state = {"touch_added": False, "high_grad_done": False}
        boxes_ref = {}
        callbacks = self._callbacks(state, boxes_ref, log)
        if self.mesh is not None:
            from fusionsense_tpu_torch.parallel.trainer import ShardedTrainer

            # ZeRO-1 whenever the capacity divides the data axis (JAX's
            # PipelineConfig.shard_optimizer, which no caller turns off)
            self.trainer = ShardedTrainer(
                ec, self.camera, self.data, gaussians, self.mesh,
                scene_scale=1.0, extra_callbacks=callbacks,
                shard_optimizer=capacity % self.mesh.shape["data"] == 0)
        else:
            self.trainer = Trainer(ec, self.camera, self.data, gaussians,
                                   scene_scale=1.0, extra_callbacks=callbacks,
                                   device=self.device)
        self.trainer.checkpoint_dir = str(self.out)
        self.trainer.image_log_dir = str(self.out / "log_images")
        if self.cfg.resume:
            self.trainer.restore(self.cfg.resume)
            # the patches live in the checkpoint as frozen Gaussians: the
            # add-once callback must not anchor them again, but the
            # recurring intruder prune still needs their boxes
            if (self.scene.touch_patches
                    and bool(self.trainer.gaussians.frozen.any())):
                state["touch_added"] = True
                boxes_ref["boxes"] = TouchBoxes.from_patches(
                    self.scene.touch_patches, self.device)
            if log and self.writer:
                log(f"resumed from {self.cfg.resume} at step "
                    f"{self.trainer.step}")
        hist = self.trainer.run(log=log)
        self.trainer.save(self.out / f"ckpt_{self.trainer.step}")
        return hist

    def _render_rcfg(self):
        """The rasterizer config of post-training renders: the trainer's
        grown K / pair budget when it outgrew the configured one."""
        rc = self.cfg.experiment.model.rasterize
        grown = getattr(self.trainer, "tile_capacity", rc.tile_capacity)
        if grown > rc.tile_capacity:
            rc = dataclasses.replace(rc, tile_capacity=grown)
        return rc

    # ------------------------------------------------------------ mesh ----
    def extract_mesh(self, method: str = "tsdf", **kw):
        """mesh_export.extract on the trained Gaussians, the train cameras
        (with the optimised pose deltas of a camera-opt run), the grown
        render config and the hull; the mesh goes to output_dir in capture
        coordinates."""
        from fusionsense_tpu_torch.mesh_export import extract

        if self.trainer is None:
            raise RuntimeError("train first")
        deltas = (self.trainer.cam_state[0]
                  if self.cfg.experiment.train.camera_opt else None)
        return extract(
            method, self.trainer.gaussians, self.camera,
            rasterize_cfg=self._render_rcfg(), out_dir=self.out,
            untransform=self.scene.untransform_points,
            hull_points=self.hull_points, cam_deltas=deltas, **kw)

    # ------------------------------------------------------------ eval ----
    def evaluate(self, split: str = "train"):
        if self.trainer is None:
            raise RuntimeError("train first")
        cam, data = ((self.camera, self.data) if split == "train"
                     else load_train_data(self.scene, self.cfg.data, split))
        # train-split eval uses the optimised camera poses
        deltas = (self.trainer.cam_state[0]
                  if split == "train"
                  and self.cfg.experiment.train.camera_opt else None)
        res = evaluate(self.trainer.gaussians, cam, data, self._render_rcfg(),
                       cam_deltas=deltas)
        with open(self.out / "metrics.json", "w") as f:
            json.dump(res, f, indent=2)
        return res
