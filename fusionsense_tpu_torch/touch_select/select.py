"""Active Touch Selection orchestrator: mesh -> ranked touch proposals.

Counterpart of fusionsense_tpu/touch_select/select.py (the user-facing flow
of the reference's VLM script, reference scripts/VLM.py:74-91
touch_selection + :386-421 main):
 1. sample a point cloud from the extracted mesh (trimesh.sample slot),
 2. VLM part reasoning: object class + ranked part names,
 3. zero-shot 3D part segmentation (render -> detect -> superpoints -> vote),
 4. ground part ranks onto the high-gradient Gaussian cloud by 1-NN,
 5. propose the next best touches sorted by (part_rank, grad_rank).
The renders (and a GLIP detector's forward) run on the device; the rest
on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from fusionsense_tpu_torch.eval.mesh_eval import sample_mesh_points
from fusionsense_tpu_torch.touch_select.partseg import Detector, segment_parts
from fusionsense_tpu_torch.touch_select.proposals import (
    TouchProposals, fuse_part_ranks, propose_touches,
)
from fusionsense_tpu_torch.touch_select.vlm import (
    PartProvider, StaticPartProvider,
)
from fusionsense_tpu_torch.utils.ply import read_pcd, read_ply, write_pcd


@dataclasses.dataclass
class TouchSelectionResult:
    classification: str
    part_names: list
    proposals: TouchProposals
    seg_points: np.ndarray
    seg_part_idx: np.ndarray


def next_best_touches(
    mesh_path,
    high_grad_pcd_path,
    part_provider: PartProvider | None = None,
    detector: Detector | None = None,
    reference_image: str | None = None,
    n_mesh_samples: int = 100_000,
    quota: int = 10,
    per_part: int = 5,
    n_views: int = 10,
    render_size: int = 400,
    out_path=None,
    device=None,
) -> TouchSelectionResult:
    """Full Active Touch Selection on `device` (the card unless "cpu" is
    asked for). Detector=None falls back to a single 'object' part
    (grad-rank-only proposals, still useful)."""
    from fusionsense_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    mesh = read_ply(mesh_path)
    if "faces" in mesh and len(mesh["faces"]):
        pts = sample_mesh_points(mesh["points"], mesh["faces"], n_mesh_samples)
    else:
        pts = mesh["points"]
    colors = mesh.get("colors")
    if colors is None or len(colors) != len(pts):
        colors = np.full((len(pts), 3), 0.5, np.float32)

    provider = part_provider or StaticPartProvider()
    resp = provider.part_names(reference_image)

    if detector is not None and len(resp.parts) > 0:
        part_idx = segment_parts(pts, colors, resp.parts, detector,
                                 n_views=n_views, render_size=render_size,
                                 device=dev)
    else:
        part_idx = np.zeros(len(pts), np.int64)

    hg = read_pcd(high_grad_pcd_path)
    hg_pts = hg["points"]
    grad_rank = np.asarray(hg.get("grad_rank", np.zeros(len(hg_pts)))
                           ).astype(np.int64)

    seg_rank = np.where(part_idx >= 0, part_idx, part_idx.max() + 1)
    part_rank = fuse_part_ranks(hg_pts, pts, seg_rank)
    proposals = propose_touches(hg_pts, part_rank, grad_rank, quota=quota,
                                per_part=per_part)
    if out_path is not None:
        write_pcd(out_path, proposals.points,
                  extra={"part_rank": proposals.part_rank.astype(np.float32),
                         "grad_rank": proposals.grad_rank.astype(np.float32)})
    return TouchSelectionResult(
        classification=resp.classification, part_names=resp.parts,
        proposals=proposals, seg_points=pts, seg_part_idx=part_idx)
