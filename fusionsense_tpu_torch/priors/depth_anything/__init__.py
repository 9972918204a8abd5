from fusionsense_tpu_torch.priors.depth_anything.dpt import (     # noqa: F401
    DAConfig, DepthAnything, tiny_da,
)
from fusionsense_tpu_torch.priors.depth_anything.predictor import (  # noqa: F401
    DepthAnythingModel, da_input_size,
)
