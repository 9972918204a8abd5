"""Grounded open-vocabulary detection (the reference's GLIP slot) in
PyTorch.

Counterpart of fusionsense_tpu/detection: the GLIP Swin-L grounding
detector the reference uses for zero-shot 3D part segmentation (reference
PartSlip/GLIP/; entry point PartSlip/src/glip_inference.py:15-77),
inference only: Swin backbone + RetinaNet FPN + BERT language backbone +
VLDyHead cross-modal tower with deformable convs, ATSS anchor decoding and
multi-label NMS. The modules carry the published checkpoint's key names
(`convert.load_glip_checkpoint`).
"""
from fusionsense_tpu_torch.detection.model import (  # noqa: F401
    GLIPConfig, GLIPModel, GLIPPredictor,
)
