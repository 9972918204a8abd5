"""Depth-Anything-V2 weights: the published checkpoint into the port's net,
and the JAX package's flax parameters back into a torch state dict.

The rule table is the port's copy of fusionsense_tpu/priors/
depth_anything/convert.py's `rules`: each key of the published state dict
(`pretrained.*` DINOv2 backbone, `depth_head.*` DPT head) with its flax
path and layout (conv NCHW <-> HWIO; convT: the ConvTranspose kernel with
its taps rotated 180 degrees; linear (out, in) <-> (in, out); the tokens
reshaped). refinenet4's resConfUnit1 gets no skip input, so the JAX net
has no counterpart for it and neither has the port's: a published file's
copy of it is dropped on load.
"""
from __future__ import annotations

from fusionsense_tpu_torch.priors import weights
from fusionsense_tpu_torch.priors.depth_anything.dpt import (
    DAConfig, DepthAnything,
)


def vit_rules(r: dict, src: str, dst: str, depth: int) -> None:
    """The DINOv2 blocks, final norm and patch embedding, into `r`."""
    r[f"{src}.patch_embed.proj.weight"] = (f"{dst}/patch_embed/kernel", "conv")
    r[f"{src}.patch_embed.proj.bias"] = (f"{dst}/patch_embed/bias", None)
    r[f"{src}.norm.weight"] = (f"{dst}/norm/scale", None)
    r[f"{src}.norm.bias"] = (f"{dst}/norm/bias", None)
    for i in range(depth):
        b, d = f"{src}.blocks.{i}", f"{dst}/block{i}"
        for n in ("norm1", "norm2"):
            r[f"{b}.{n}.weight"] = (f"{d}/{n}/scale", None)
            r[f"{b}.{n}.bias"] = (f"{d}/{n}/bias", None)
        for s, t in (("attn.qkv", "attn/qkv"), ("attn.proj", "attn/proj"),
                     ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            r[f"{b}.{s}.weight"] = (f"{d}/{t}/kernel", "linear")
            r[f"{b}.{s}.bias"] = (f"{d}/{t}/bias", None)
        r[f"{b}.ls1.gamma"] = (f"{d}/ls1", None)
        r[f"{b}.ls2.gamma"] = (f"{d}/ls2", None)


def dpt_rules(r: dict, src: str, dst: str, refine, scratch) -> None:
    """The reassembly and fusion layers into `r`: `refine(i)` (i = 1..4)
    and `scratch(i)` (i = 0..3) are the torch key prefixes of a level's
    fusion block and scratch conv."""
    def conv(s, d, bias=True, kind="conv"):
        r[f"{s}.weight"] = (f"{d}/kernel", kind)
        if bias:
            r[f"{s}.bias"] = (f"{d}/bias", None)

    for i in range(4):
        conv(f"{src}.projects.{i}", f"{dst}/project{i}")
        conv(scratch(i), f"{dst}/scratch{i}", bias=False)
    conv(f"{src}.resize_layers.0", f"{dst}/resize0", kind="convT")
    conv(f"{src}.resize_layers.1", f"{dst}/resize1", kind="convT")
    conv(f"{src}.resize_layers.3", f"{dst}/resize3")
    for i in range(1, 5):
        rb, db = refine(i), f"{dst}/refine{i}"
        units = ((2, "rcu2"),) if i == 4 else ((1, "rcu1"), (2, "rcu2"))
        for u, fu in units:
            conv(f"{rb}.resConfUnit{u}.conv1", f"{db}/{fu}/conv1")
            conv(f"{rb}.resConfUnit{u}.conv2", f"{db}/{fu}/conv2")
        conv(f"{rb}.out_conv", f"{db}/out_conv")


def rules(cfg: DAConfig = DAConfig()) -> dict:
    """{torch key: (flax path, layout kind)}."""
    r = {"pretrained.cls_token": ("pretrained/cls_token", None),
         "pretrained.pos_embed": ("pretrained/pos_embed", None)}
    vit_rules(r, "pretrained", "pretrained", cfg.vit.depth)
    d = "depth_head"
    dpt_rules(r, d, d, lambda i: f"{d}.scratch.refinenet{i}",
              lambda i: f"{d}.scratch.layer{i + 1}_rn")
    for s, t in (("output_conv1", "out_conv1"),
                 ("output_conv2.0", "out_conv2a"),
                 ("output_conv2.2", "out_conv2b")):
        r[f"{d}.scratch.{s}.weight"] = (f"{d}/{t}/kernel", "conv")
        r[f"{d}.scratch.{s}.bias"] = (f"{d}/{t}/bias", None)
    return r


def state_dict_from_flax(params: dict, cfg: DAConfig = DAConfig()) -> dict:
    """The JAX package's flax DepthAnything params -> the port's state dict."""
    return weights.state_dict_from_flax(
        params, rules(cfg), weights.shapes_of(lambda: DepthAnything(cfg)))


def load_da_checkpoint(path: str, cfg: DAConfig = DAConfig()) -> DepthAnything:
    """A Depth-Anything-V2 checkpoint file -> the port's net on the CPU, in
    eval mode (`ckpt["state_dict"]` when present, as the JAX converter
    reads it)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return weights.load_filtered(DepthAnything(cfg), sd, strip=()).eval()
