"""fs-eval in the port: render quality + chamfer from a checkpoint.

    python -m fusionsense_tpu_torch.cli.eval --checkpoint <ckpt> --data <scene>

The flags, their defaults and choices are those of fusionsense_tpu's
fs-eval (the reference's ns-eval, masked rendering eval and chamfer eval,
eval_utils/rendering_evaluation.py, mask_rendering_eval.py,
chamfer_evaluation.py), restoring the Gaussians from an fs-train
checkpoint of the port. The renders run on the card.
"""
from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser("fs-eval", description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--output-path", default="metrics.json")
    p.add_argument("--gt-mesh", default=None,
                   help="CAD ground-truth .ply for chamfer eval")
    p.add_argument("--gt-mesh-unit", type=float, default=1e-3,
                   help="scale of GT mesh units to meters (mm default)")
    p.add_argument("--pred-mesh", default=None,
                   help="extracted mesh/pcd .ply to compare (capture coords)")
    p.add_argument("--backend", choices=["jax", "pallas", "flat"],
                   default="jax")
    return p


def main(argv=None, device=None):
    """Parse argv, evaluate, write --output-path; returns the results.
    `device` is where the renders run (the card by default; the tests pass
    "cpu")."""
    args = build_parser().parse_args(argv)

    import numpy as np

    from fusionsense_tpu_torch.data.dataparser import (
        DataParserConfig, load_train_data, parse_transforms,
    )
    from fusionsense_tpu_torch.device import resolve_device
    from fusionsense_tpu_torch.eval.evaluator import evaluate
    from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
    from fusionsense_tpu_torch.train.checkpoint import (
        checkpoint_sh_degree, load_for_inference,
    )

    dev = resolve_device(device)
    gaussians, step, cam_state = load_for_inference(args.checkpoint,
                                                    device=dev)
    dcfg = DataParserConfig(data_dir=args.data)
    scene = parse_transforms(dcfg, device=dev)
    camera, data = load_train_data(scene, dcfg, args.split)
    # optimised camera poses apply only to the split they were learned on
    deltas = None
    if cam_state is not None and args.split == "train":
        d = cam_state[0]
        if d.shape[0] == data.images.shape[0] and bool((d != 0).any()):
            deltas = d
    res = evaluate(gaussians, camera, data,
                   RasterizeConfig(backend=args.backend,
                                   sh_degree=checkpoint_sh_degree(gaussians)),
                   cam_deltas=deltas)
    res["step"] = step

    if args.gt_mesh and args.pred_mesh:
        from fusionsense_tpu_torch.eval.chamfer import chamfer_eval
        from fusionsense_tpu_torch.utils.ply import read_ply

        gt = read_ply(args.gt_mesh)["points"]
        pred = read_ply(args.pred_mesh)["points"]
        # per-touch-site local chamfer when the capture has tactile data
        # (reference touch_CD_eval reads gelsight_transform.json centers,
        # eval_utils/chamfer_evaluation.py:101-114)
        centers = None
        if scene.touch_patches:
            centers = np.stack([p.bbox_center for p in scene.touch_patches])
        res["chamfer"] = chamfer_eval(pred, gt,
                                      gt_unit_scale=args.gt_mesh_unit,
                                      touch_centers=centers)

    with open(args.output_path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res["mean"], indent=2))
    return res


if __name__ == "__main__":
    main()
