from fusionsense_tpu_torch.viewer.server import (   # noqa: F401
    SplatViewerServer, ViewerCallback, pack_splats, pack_state,
)
