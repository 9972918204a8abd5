"""Omnidata DPT-Hybrid weights: the published checkpoint into the port's
net, and the JAX package's flax parameters back into a torch state dict.

The rule table is the port's copy of fusionsense_tpu/priors/omnidata/
convert.py's `rules`: each key of ``omnidata_dpt_normal_v2.ckpt``'s state
dict (MiDaS/timm layout, after the "model." prefix; loaded by reference
dn_splatter/scripts/normals_from_pretrain.py:309-322) with its flax path
and layout (conv NCHW <-> HWIO; linear (out, in) <-> (in, out); the 1x1
patch embedding as a flax Dense; the tokens reshaped). refinenet4's
resConfUnit1 gets no skip input: the flax net has no counterpart for it,
the port's module keeps the published weights unused.
"""
from __future__ import annotations

from fusionsense_tpu_torch.priors import weights
from fusionsense_tpu_torch.priors.omnidata.dpt_hybrid import (
    OmniConfig, OmnidataNormals,
)

DEAD_PREFIX = "scratch.refinenet4.resConfUnit1."


def rules(cfg: OmniConfig = OmniConfig()) -> dict:
    """{torch key: (flax path, layout kind)}."""
    r: dict = {}

    def conv(src, dst, bias=True):
        r[f"{src}.weight"] = (f"{dst}/kernel", "conv")
        if bias:
            r[f"{src}.bias"] = (f"{dst}/bias", None)

    def lin(src, dst):
        r[f"{src}.weight"] = (f"{dst}/kernel", "linear")
        r[f"{src}.bias"] = (f"{dst}/bias", None)

    def norm(src, dst):
        r[f"{src}.weight"] = (f"{dst}/scale", None)
        r[f"{src}.bias"] = (f"{dst}/bias", None)

    m = "pretrained.model"
    bb = f"{m}.patch_embed.backbone"
    conv(f"{bb}.stem.conv", "backbone/stem_conv", bias=False)
    norm(f"{bb}.stem.norm", "backbone/stem_norm")
    for si, reps in enumerate(cfg.stage_layout):
        for bi in range(reps):
            src = f"{bb}.stages.{si}.blocks.{bi}"
            dst = f"backbone/stage{si}_block{bi}"
            for k in (1, 2, 3):
                norm(f"{src}.norm{k}", f"{dst}/norm{k}")
                conv(f"{src}.conv{k}", f"{dst}/conv{k}", bias=False)
            if bi == 0:
                conv(f"{src}.downsample.conv", f"{dst}/downsample_conv",
                     bias=False)
    r[f"{m}.patch_embed.proj.weight"] = ("patch_embed/kernel", "se")
    r[f"{m}.patch_embed.proj.bias"] = ("patch_embed/bias", None)
    r[f"{m}.cls_token"] = ("cls_token", None)
    r[f"{m}.pos_embed"] = ("pos_embed", None)
    for i in range(cfg.vit_depth):
        src, dst = f"{m}.blocks.{i}", f"block{i}"
        norm(f"{src}.norm1", f"{dst}/norm1")
        lin(f"{src}.attn.qkv", f"{dst}/qkv")
        lin(f"{src}.attn.proj", f"{dst}/attn_proj")
        norm(f"{src}.norm2", f"{dst}/norm2")
        lin(f"{src}.mlp.fc1", f"{dst}/fc1")
        lin(f"{src}.mlp.fc2", f"{dst}/fc2")

    lin("pretrained.act_postprocess3.0.project.0", "readout3_proj")
    lin("pretrained.act_postprocess4.0.project.0", "readout4_proj")
    conv("pretrained.act_postprocess3.3", "post3")
    conv("pretrained.act_postprocess4.3", "post4a")
    conv("pretrained.act_postprocess4.4", "post4b")

    for i in range(4):
        conv(f"scratch.layer{i + 1}_rn", f"scratch{i + 1}", bias=False)
    for i in range(1, 5):
        src, dst = f"scratch.refinenet{i}", f"refine{i}"
        for u, fu in ((1, "rcu1"), (2, "rcu2")):
            if i == 4 and u == 1:
                continue      # no skip reaches it: the flax net has none
            conv(f"{src}.resConfUnit{u}.conv1", f"{dst}/{fu}/conv1")
            conv(f"{src}.resConfUnit{u}.conv2", f"{dst}/{fu}/conv2")
        conv(f"{src}.out_conv", f"{dst}/out_conv")
    conv("scratch.output_conv.0", "head0")
    conv("scratch.output_conv.2", "head2")
    conv("scratch.output_conv.4", "head4")
    return r


def state_dict_from_flax(params: dict, cfg: OmniConfig = OmniConfig()) -> dict:
    """The JAX package's flax OmnidataNormals params -> the port's state
    dict; refinenet4's unused resConfUnit1, which the flax tree lacks, as
    zeros."""
    import torch

    shapes = weights.shapes_of(lambda: OmnidataNormals(cfg))
    sd = weights.state_dict_from_flax(params, rules(cfg), shapes)
    for k, shape in shapes.items():
        if k.startswith(DEAD_PREFIX):
            sd[k] = torch.zeros(shape)
    return sd


def load_omnidata_checkpoint(path: str, cfg: OmniConfig = OmniConfig()):
    """An omnidata checkpoint file -> (the port's net on the CPU in eval
    mode, {"missing": [...], "unused": [...]}). The published file is
    Lightning-style ({"state_dict": {"model.<key>": ...}}); "model." is
    taken off twice, as the JAX converter does (once on loading, once per
    key). The keys the net lacks (timm's final norm and classifier) are
    reported unused and skipped; a key the net needs and the file lacks
    raises."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    net = OmnidataNormals(cfg)
    want = set(net.state_dict())
    have = {k.removeprefix("model.").removeprefix("model.") for k in state}
    report = {"missing": sorted(want - have), "unused": sorted(have - want)}
    weights.load_filtered(net, state, strip=("model.", "model."))
    return net.eval(), report
