"""DSINE surface-normal network (the reference's default monocular-normal
prior, dn_splatter/scripts/dsine/; selected at scripts/train.py:101):
the tf-SAME EfficientNet-B5 encoder, the GN decoder with weight-
standardised convs, the rotation-based neighbourhood refinement, the
checkpoint loader and the predictor."""
from fusionsense_tpu_torch.priors.dsine.model import DSINE  # noqa: F401
from fusionsense_tpu_torch.priors.dsine.predictor import DSinePredictor  # noqa: F401
