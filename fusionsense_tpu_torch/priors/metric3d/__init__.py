from fusionsense_tpu_torch.priors.metric3d.model import (  # noqa: F401
    M3DConfig, Metric3D, tiny_m3d,
)
from fusionsense_tpu_torch.priors.metric3d.predictor import (  # noqa: F401
    Metric3DPredictor,
)
from fusionsense_tpu_torch.priors.metric3d.wrapper import (  # noqa: F401
    Metric3DPipeline,
)
