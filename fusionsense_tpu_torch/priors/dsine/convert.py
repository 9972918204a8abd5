"""DSINE weights: the published checkpoint into the port's net, and the JAX
package's flax parameters back into a torch state dict.

The rule table is the port's copy of fusionsense_tpu/priors/dsine/
convert.py's build_rules: each torch key of the published checkpoint
(torch.hub `dsine.pt`, loaded by reference dsine_predictor.py:52-66; geffnet
tf_efficientnet_b5_ap for the encoder) with its flax path and layout
(conv: NCHW <-> HWIO, depthwise included; se: the SE 1x1 convs as flax
Dense; BatchNorm statistics as flax parameters).
"""
from __future__ import annotations

from fusionsense_tpu_torch.priors import weights
from fusionsense_tpu_torch.priors.dsine.model import DSINE, DSINEConfig


def _bn(src: str, dst: str):
    return {f"{src}.weight": (f"{dst}/scale", None),
            f"{src}.bias": (f"{dst}/bias", None),
            f"{src}.running_mean": (f"{dst}/mean", None),
            f"{src}.running_var": (f"{dst}/var", None)}


def _conv(src: str, dst: str, bias=True):
    rules = {f"{src}.weight": (f"{dst}/kernel", "conv")}
    if bias:
        rules[f"{src}.bias"] = (f"{dst}/bias", None)
    return rules


def _se(src: str, dst: str):
    r = {}
    for name in ("conv_reduce", "conv_expand"):
        r[f"{src}.se.{name}.weight"] = (f"{dst}/se/{name}/kernel", "se")
        r[f"{src}.se.{name}.bias"] = (f"{dst}/se/{name}/bias", None)
    return r


def _head(src: str, dst: str):
    r = {}
    for t_idx, name in ((0, "conv0"), (2, "conv1"), (4, "conv2")):
        r.update(_conv(f"{src}.{t_idx}", f"{dst}/{name}"))
    return r


def build_rules(cfg: DSINEConfig = DSINEConfig()) -> dict:
    """{torch key: (flax path, layout kind)}."""
    r: dict = {}
    enc = "encoder.original_model"
    r.update(_conv(f"{enc}.conv_stem", "encoder/conv_stem", bias=False))
    r.update(_bn(f"{enc}.bn1", "encoder/bn1"))
    for i, (reps, _out, _k, _s, exp) in enumerate(cfg.effnet.stages):
        for j in range(reps):
            src = f"{enc}.blocks.{i}.{j}"
            dst = f"encoder/blocks_{i}_{j}"
            if exp == 1:     # DepthwiseSeparable
                r.update(_conv(f"{src}.conv_dw", f"{dst}/conv_dw", bias=False))
                r.update(_bn(f"{src}.bn1", f"{dst}/bn1"))
                r.update(_se(src, dst))
                r.update(_conv(f"{src}.conv_pw", f"{dst}/conv_pw", bias=False))
                r.update(_bn(f"{src}.bn2", f"{dst}/bn2"))
            else:            # InvertedResidual
                r.update(_conv(f"{src}.conv_pw", f"{dst}/conv_pw", bias=False))
                r.update(_bn(f"{src}.bn1", f"{dst}/bn1"))
                r.update(_conv(f"{src}.conv_dw", f"{dst}/conv_dw", bias=False))
                r.update(_bn(f"{src}.bn2", f"{dst}/bn2"))
                r.update(_se(src, dst))
                r.update(_conv(f"{src}.conv_pwl", f"{dst}/conv_pwl",
                               bias=False))
                r.update(_bn(f"{src}.bn3", f"{dst}/bn3"))
    r.update(_conv(f"{enc}.conv_head", "encoder/conv_head", bias=False))

    # decoder
    r.update(_conv("decoder.conv2", "conv2"))
    for up in ("up1", "up2"):
        for t_idx, (cname, gname) in ((0, ("conv0", "gn0")),
                                      (3, ("conv1", "gn1"))):
            r.update(_conv(f"decoder.{up}._net.{t_idx}", f"{up}/{cname}"))
            r[f"decoder.{up}._net.{t_idx + 1}.weight"] = (
                f"{up}/{gname}/scale", None)
            r[f"decoder.{up}._net.{t_idx + 1}.bias"] = (
                f"{up}/{gname}/bias", None)
    for head in ("normal_head", "feature_head", "hidden_head"):
        r.update(_head(f"decoder.{head}", head))

    # refinement
    for g in ("convz", "convr", "convq"):
        r.update(_conv(f"gru.{g}", f"gru/{g}"))
    for head in ("prob_head", "xy_head", "angle_head", "up_prob_head"):
        r.update(_head(head, head))
    return r


def state_dict_from_flax(params: dict, cfg: DSINEConfig = DSINEConfig()) -> dict:
    """The JAX package's flax DSINE params -> the port's state dict."""
    return weights.state_dict_from_flax(
        params, build_rules(cfg), weights.shapes_of(lambda: DSINE(cfg)))


def load_dsine_checkpoint(path: str, cfg: DSINEConfig = DSINEConfig()) -> DSINE:
    """A DSINE checkpoint file -> the port's net on the CPU, in eval mode.
    Unwrapped as the JAX converter does (`ckpt["model"]` when present,
    "module."/"model." prefixes taken off)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return weights.load_filtered(DSINE(cfg), state).eval()
