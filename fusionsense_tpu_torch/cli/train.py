"""fs-train in the port: end-to-end reconstruction from a capture on disk.

    python -m fusionsense_tpu_torch.cli.train --data <scene>
    torchrun --nproc-per-node 8 -m fusionsense_tpu_torch.cli.train \
        --data <scene> --device-mesh data=2,tile=2,gauss=2

The flags, their defaults and choices are those of fusionsense_tpu's
fs-train: after training, the meshes of --mesh (tsdf and sugar-coarse by
default; an empty --mesh extracts none) go to the output directory, then
the train split is evaluated; --viewer serves the live model while it
trains. The run is on the card. --device-mesh trains on a data x tile x
gauss mesh of ranks, one process per rank as torchrun starts them (the
axes multiply to the number of processes; parallel/mesh.py states the
backend rule: nccl with a card per rank, gloo where ranks share a card);
rank 0 alone writes the checkpoints, meshes, metrics.json and the log. A
mesh that does not fit the ranks raises before the scene is read.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser("fs-train", description=__doc__)
    p.add_argument("--data", required=True, help="scene dir with transforms.json")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--experiment-name", default="dn_splatter")
    p.add_argument("--load-touches", action="store_true",
                   help="Module 3: anchor tactile patches")
    p.add_argument("--iterations", type=int, default=15_000)
    p.add_argument("--steps-per-save", type=int, default=15_000,
                   help="periodic checkpoint cadence")
    p.add_argument("--stop-split-at", type=int, default=10_000)
    p.add_argument("--warmup-length", type=int, default=500)
    p.add_argument("--add-touch-at", type=int, default=1_000)
    p.add_argument("--capacity", type=int, default=2 ** 18)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--normal-lambda", type=float, default=0.4)
    p.add_argument("--sensor-depth-lambda", type=float, default=0.2)
    p.add_argument("--mono-depth-lambda", type=float, default=0.2)
    p.add_argument("--smooth-lambda", type=float, default=0.1)
    p.add_argument("--binary-opacities", action="store_true", default=True)
    p.add_argument("--no-binary-opacities", dest="binary_opacities",
                   action="store_false")
    p.add_argument("--downscale-factor", type=int, default=1)
    p.add_argument("--tile-capacity", type=int, default=512)
    p.add_argument("--backend", choices=["jax", "pallas", "flat"],
                   default="jax",
                   help="compositing backend: jax (plain PyTorch), pallas "
                        "(dense-tile CUDA kernels K3/K4), flat "
                        "(segmented-pair CUDA kernels K1/K2)")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume mid-training from a saved checkpoint "
                        "(restores camera-optimizer + adaptive policy state)")
    p.add_argument("--scan-chunk", type=int, default=100)
    p.add_argument("--mesh", nargs="*", default=["tsdf", "sugar-coarse"],
                   help="mesh methods to extract after training")
    p.add_argument("--skip-eval", action="store_true")
    p.add_argument("--viewer", action="store_true",
                   help="serve the live WebGL splat viewer while training")
    p.add_argument("--viewer-port", type=int, default=7007)
    p.add_argument("--device-mesh", default=None,
                   help="multi-device axis spec, e.g. data=2,tile=2,gauss=2 "
                        "(axes multiply to the number of ranks)")
    return p


def main(argv=None, device=None):
    """Parse argv, train, evaluate; returns the pipeline. `device` is where
    the run goes (the card by default; the tests pass "cpu")."""
    args = build_parser().parse_args(argv)

    from fusionsense_tpu_torch.config import (
        ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
    )
    from fusionsense_tpu_torch.data.dataparser import DataParserConfig
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig
    from fusionsense_tpu_torch.pipeline import (
        PipelineConfig, ReconstructionPipeline,
    )
    from fusionsense_tpu_torch.render.rasterize import RasterizeConfig

    out = Path(args.output_dir) / args.experiment_name
    cfg = PipelineConfig(
        data=DataParserConfig(data_dir=args.data,
                              load_touches=args.load_touches,
                              downscale_factor=args.downscale_factor),
        experiment=ExperimentConfig(
            model=ModelConfig(
                sh_degree=args.sh_degree,
                capacity=args.capacity,
                binary_opacities=args.binary_opacities,
                rasterize=RasterizeConfig(
                    tile_capacity=args.tile_capacity, backend=args.backend,
                    sh_degree=args.sh_degree),
            ),
            train=TrainConfig(
                iterations=args.iterations, scan_chunk=args.scan_chunk,
                add_touch_at=args.add_touch_at,
                steps_per_save=args.steps_per_save,
                adc=ADCConfig(warmup=args.warmup_length,
                              stop_split_at=args.stop_split_at),
            ),
            loss=LossConfig(
                normal_lambda=args.normal_lambda,
                sensor_depth_lambda=args.sensor_depth_lambda,
                mono_depth_lambda=args.mono_depth_lambda,
                smooth_lambda=args.smooth_lambda,
            ),
        ),
        output_dir=str(out),
        device_mesh=args.device_mesh,
        viewer=args.viewer, viewer_port=args.viewer_port,
        resume=args.resume,
    )
    pipe = ReconstructionPipeline(cfg, device=device)
    pipe.train()
    if not pipe.writer:
        return pipe
    for method in args.mesh:
        verts, faces, path = pipe.extract_mesh(method)
        print(f"mesh[{method}]: {len(verts)} verts -> {path}")
    if not args.skip_eval:
        res = pipe.evaluate("train")
        print(json.dumps(res["mean"], indent=2))
    return pipe


if __name__ == "__main__":
    pipe = main()
    if pipe.mesh is not None:
        pipe.mesh.close()
