"""Metric3D weights: a checkpoint into the port's net, and the JAX
package's flax parameters back into a torch state dict.

The rule table is the port's copy of fusionsense_tpu/priors/metric3d/
convert.py's `rules`, pinned, as that converter is, to the layout of the
torch replica its tests hold it against (the hub source is not vendored).
STRIP_PREFIXES takes the common hub wrappers (module./model./depth_model.)
off the keys before they are matched.
"""
from __future__ import annotations

from fusionsense_tpu_torch.priors import weights
from fusionsense_tpu_torch.priors.depth_anything.convert import (
    dpt_rules, vit_rules,
)
from fusionsense_tpu_torch.priors.metric3d.model import M3DConfig, Metric3D

STRIP_PREFIXES = ("module.", "model.", "depth_model.")


def rules(cfg: M3DConfig = M3DConfig()) -> dict:
    """{torch key: (flax path, layout kind)}."""
    e, de = "encoder", "decoder"
    r = {f"{e}.{k}": (f"{e}/{k}", None)
         for k in ("cls_token", "register_tokens", "pos_embed")}
    vit_rules(r, e, e, cfg.depth)
    dpt_rules(r, de, de, lambda i: f"{de}.refinenet{i}",
              lambda i: f"{de}.scratch.{i}")
    for name in ("init_pred", "init_hidden", "init_context", "gru.convz",
                 "gru.convr", "gru.convq", "delta_hidden", "delta_head",
                 "up_mask"):
        dst = f"{de}/{name.replace('.', '/')}"
        r[f"{de}.{name}.weight"] = (f"{dst}/kernel", "conv")
        r[f"{de}.{name}.bias"] = (f"{dst}/bias", None)
    return r


def state_dict_from_flax(params: dict, cfg: M3DConfig = M3DConfig()) -> dict:
    """The JAX package's flax Metric3D params -> the port's state dict."""
    return weights.state_dict_from_flax(
        params, rules(cfg), weights.shapes_of(lambda: Metric3D(cfg)))


def load_metric3d_checkpoint(path: str,
                             cfg: M3DConfig = M3DConfig()) -> Metric3D:
    """A Metric3D checkpoint file -> the port's net on the CPU, in eval mode
    (`model_state_dict`, else `state_dict`, else the file's dict, as the
    JAX converter unwraps it)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state_dict", ckpt.get("state_dict", ckpt))
    return weights.load_filtered(Metric3D(cfg), state,
                                 strip=STRIP_PREFIXES).eval()
