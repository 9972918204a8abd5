"""fs-mesh in the port: mesh extraction from a checkpoint.

    python -m fusionsense_tpu_torch.cli.mesh tsdf --checkpoint <ckpt> --data <scene>

The flags, their defaults and choices are those of fusionsense_tpu's
fs-mesh (the reference's `gs-mesh {tsdf,dn,sugar-coarse,gaussians,
marching}`, export_mesh.py:926-943), restoring the Gaussians from an
fs-train checkpoint of the port. The extraction runs on the card.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser("fs-mesh", description=__doc__)
    p.add_argument("method",
                   choices=["tsdf", "dn", "sugar-coarse", "gaussians",
                            "marching"])
    p.add_argument("--checkpoint", required=True,
                   help="fs-train checkpoint dir (ckpt_<step>)")
    p.add_argument("--data", required=True, help="scene dir (for cameras)")
    p.add_argument("--output-dir", default=None,
                   help="default: checkpoint parent")
    p.add_argument("--resolution", type=int, default=192)
    p.add_argument("--voxel-size", type=float, default=None,
                   help="tsdf: fuse at this FIXED metric voxel (reference "
                        "vdbfusion 0.004); room-scale scenes switch to the "
                        "sparse brick-hash volume automatically")
    p.add_argument("--level", type=float, default=0.3,
                   help="sugar-coarse density level")
    p.add_argument("--levels", type=float, nargs="*", default=None,
                   help="extract at multiple density levels (sugar-coarse)")
    p.add_argument("--level-mode",
                   choices=["absolute", "relative", "peak"],
                   default="absolute",
                   help="sugar-coarse surface localization: 'absolute' = "
                        "reference level-crossing semantics; 'relative' = "
                        "level x ray-max density (scale-invariant); 'peak' = "
                        "density-peak refinement (least surface bias)")
    p.add_argument("--tile-capacity", type=int, default=512)
    p.add_argument("--backend", choices=["jax", "pallas", "flat"],
                   default="jax")
    return p


def main(argv=None, device=None):
    """Parse argv and extract; returns [(verts, faces, path)] per level.
    `device` is where it runs (the card by default; the tests pass
    "cpu")."""
    args = build_parser().parse_args(argv)

    from fusionsense_tpu_torch.data.dataparser import (
        DataParserConfig, load_train_data, parse_transforms,
    )
    from fusionsense_tpu_torch.device import resolve_device
    from fusionsense_tpu_torch.mesh_export import extract
    from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
    from fusionsense_tpu_torch.train.checkpoint import (
        checkpoint_sh_degree, load_for_inference,
    )

    dev = resolve_device(device)
    gaussians, step, cam_state = load_for_inference(args.checkpoint,
                                                    device=dev)
    dcfg = DataParserConfig(data_dir=args.data)
    scene = parse_transforms(dcfg, device=dev)
    camera, _ = load_train_data(scene, dcfg, "train")
    # camera-opt runs: fuse depth from the optimised train poses
    deltas = None
    if cam_state is not None:
        d = cam_state[0]
        if d.shape[0] == camera.viewmat.shape[0] and bool((d != 0).any()):
            deltas = d
    out = Path(args.output_dir or Path(args.checkpoint).parent)
    rcfg = RasterizeConfig(tile_capacity=args.tile_capacity,
                           backend=args.backend,
                           sh_degree=checkpoint_sh_degree(gaussians))
    levels = args.levels if args.levels else [args.level]
    results = []
    for lvl in levels:
        verts, faces, path = extract(
            args.method, gaussians, camera, rcfg, out,
            untransform=scene.untransform_points,
            hull_points=scene.hull_points, resolution=args.resolution,
            level=lvl, level_mode=args.level_mode, cam_deltas=deltas,
            voxel_size=args.voxel_size)
        print(f"mesh[{args.method}] level {lvl} @ step {step}: "
              f"{len(verts)} verts, {len(faces)} faces -> {path}")
        results.append((verts, faces, path))
    return results


if __name__ == "__main__":
    main()
