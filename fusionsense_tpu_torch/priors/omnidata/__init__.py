"""Omnidata DPT-Hybrid normal prior (the reference's `--model-type
omnidata`, dn_splatter/scripts/normals_from_pretrain.py): the net, the
checkpoint loader, the HD patch merge and the predictor."""
from fusionsense_tpu_torch.priors.omnidata.dpt_hybrid import (  # noqa: F401
    OmniConfig, OmnidataNormals, tiny_omni,
)
from fusionsense_tpu_torch.priors.omnidata.predictor import (  # noqa: F401
    OmnidataPredictor,
)
