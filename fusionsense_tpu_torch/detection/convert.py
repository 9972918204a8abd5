"""GLIP weights: the published checkpoint into the port's model, and the
JAX package's flax parameters back into a torch state dict.

The port's module names are the published checkpoint's key names
(glip_large_model.pth, PartSlip/download_ckpts.sh:7), so a checkpoint
loads with load_state_dict(strict=True) once "module." is taken off and
the keys the model does not have (cls_logits, the relative position
indices, the pooler and other training-only entries, as the JAX converter
skips them) are dropped. The rule table is the port's copy of
fusionsense_tpu/detection/convert.py's build_rules, each torch key with its
flax path and its layout kind (conv: OIHW <-> HWIO, linear: transposed);
`state_dict_from_flax` inverts it.
"""
from __future__ import annotations

from fusionsense_tpu_torch.detection.model import GLIPConfig, GLIPModel
from fusionsense_tpu_torch.priors import weights


def _bert_layer_rules(dst_prefix: str):
    """HF bert layer key suffix -> (flax path, kind)."""
    r = {}
    for src, dst, kind in (
            ("attention.self.query", "attention/query", "linear"),
            ("attention.self.key", "attention/key", "linear"),
            ("attention.self.value", "attention/value", "linear"),
            ("attention.output.dense", "attention/out", "linear"),
            ("attention.output.LayerNorm", "attention_norm", "norm"),
            ("intermediate.dense", "intermediate", "linear"),
            ("output.dense", "output", "linear"),
            ("output.LayerNorm", "output_norm", "norm")):
        if kind == "norm":
            r.update(_norm(src, f"{dst_prefix}/{dst}"))
        else:
            r.update(_linear(src, f"{dst_prefix}/{dst}"))
    return r


def _norm(src: str, dst: str):
    return {f"{src}.weight": (f"{dst}/scale", None),
            f"{src}.bias": (f"{dst}/bias", None)}


def _linear(src: str, dst: str, bias=True):
    rules = {f"{src}.weight": (f"{dst}/kernel", "linear")}
    if bias:
        rules[f"{src}.bias"] = (f"{dst}/bias", None)
    return rules


def _conv(src: str, dst: str):
    return {f"{src}.weight": (f"{dst}/kernel", "conv"),
            f"{src}.bias": (f"{dst}/bias", None)}


def build_rules(depths=(2, 2, 18, 2), num_convs: int = 8,
                bert_layers: int = 12) -> dict:
    """{torch key: (flax 'a/b/c' path, layout kind)}."""
    r: dict = {}

    # ---- Swin backbone -------------------------------------------------
    bb = "backbone.body"
    r.update(_conv(f"{bb}.patch_embed.proj", "backbone/patch_embed_proj"))
    r.update(_norm(f"{bb}.patch_embed.norm", "backbone/patch_embed_norm"))
    for i, depth in enumerate(depths):
        for b in range(depth):
            src = f"{bb}.layers.{i}.blocks.{b}"
            dst = f"backbone/layers_{i}_blocks_{b}"
            r.update(_norm(f"{src}.norm1", f"{dst}/norm1"))
            r[f"{src}.attn.relative_position_bias_table"] = (
                f"{dst}/attn/relative_position_bias_table", None)
            r.update(_linear(f"{src}.attn.qkv", f"{dst}/attn/qkv"))
            r.update(_linear(f"{src}.attn.proj", f"{dst}/attn/proj"))
            r.update(_norm(f"{src}.norm2", f"{dst}/norm2"))
            r.update(_linear(f"{src}.mlp.fc1", f"{dst}/mlp_fc1"))
            r.update(_linear(f"{src}.mlp.fc2", f"{dst}/mlp_fc2"))
        if i < len(depths) - 1:
            src = f"{bb}.layers.{i}.downsample"
            dst = f"backbone/layers_{i}_downsample"
            r.update(_norm(f"{src}.norm", f"{dst}/norm"))
            r.update(_linear(f"{src}.reduction", f"{dst}/reduction",
                             bias=False))
    for i in (1, 2, 3):     # out norms for stages used by the FPN
        r.update(_norm(f"{bb}.norm{i}", f"backbone/out_norm{i}"))

    # ---- FPN -----------------------------------------------------------
    for i in (1, 2, 3):     # torch names are fpn_inner2..4 (idx from 1, 0 skipped)
        r.update(_conv(f"backbone.fpn.fpn_inner{i + 1}", f"fpn/fpn_inner{i}"))
        r.update(_conv(f"backbone.fpn.fpn_layer{i + 1}", f"fpn/fpn_layer{i}"))
    r.update(_conv("backbone.fpn.top_blocks.p6", "fpn/p6"))
    r.update(_conv("backbone.fpn.top_blocks.p7", "fpn/p7"))

    # ---- BERT language backbone ----------------------------------------
    lb = "language_backbone.body.model"
    for name in ("word", "position", "token_type"):
        r[f"{lb}.embeddings.{name}_embeddings.weight"] = (
            f"language_backbone/{name}_embeddings", None)
    r.update(_norm(f"{lb}.embeddings.LayerNorm",
                   "language_backbone/embeddings_norm"))
    for i in range(bert_layers):
        for k, v in _bert_layer_rules(f"language_backbone/layer_{i}").items():
            r[f"{lb}.encoder.layer.{i}.{k}"] = v

    # ---- VLDyHead tower --------------------------------------------------
    hd = "rpn.head"
    for i in range(num_convs):
        # VLFuse at tower index 3i
        fz = f"{hd}.dyhead_tower.{3 * i}.b_attn"
        dz = f"head/fuse_{i}/b_attn"
        r[f"{fz}.gamma_v"] = (f"{dz}/gamma_v", None)
        r[f"{fz}.gamma_l"] = (f"{dz}/gamma_l", None)
        r.update(_norm(f"{fz}.layer_norm_v", f"{dz}/layer_norm_v"))
        r.update(_norm(f"{fz}.layer_norm_l", f"{dz}/layer_norm_l"))
        for p in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                  "out_v_proj", "out_l_proj"):
            r.update(_linear(f"{fz}.attn.{p}", f"{dz}/attn/{p}"))
        # BertEncoderLayer at 3i+1
        for k, v in _bert_layer_rules(f"head/lang_layer_{i}").items():
            r[f"{hd}.dyhead_tower.{3 * i + 1}.{k}"] = v
        # DyConv at 3i+2: torch DyConv.0 -> up branch, .1 -> same, .2 -> down
        dc = f"{hd}.dyhead_tower.{3 * i + 2}"
        dd = f"head/dyconv_{i}"
        for t_idx, branch in ((0, "conv_up"), (1, "conv_mid"),
                              (2, "conv_down")):
            r[f"{dc}.DyConv.{t_idx}.conv.weight"] = (
                f"{dd}/{branch}/weight", "conv")
            r[f"{dc}.DyConv.{t_idx}.conv.bias"] = (
                f"{dd}/{branch}/bias", None)
            r.update(_norm(f"{dc}.DyConv.{t_idx}.bn", f"{dd}/{branch}/gn"))
        r.update(_conv(f"{dc}.AttnConv.1", f"{dd}/attn_conv"))
        r.update(_conv(f"{dc}.offset", f"{dd}/offset"))
        r.update(_linear(f"{dc}.relu.fc.0", f"{dd}/dyrelu/fc1"))
        r.update(_linear(f"{dc}.relu.fc.2", f"{dd}/dyrelu/fc2"))

    # ---- prediction heads ------------------------------------------------
    r.update(_conv(f"{hd}.bbox_pred", "head/bbox_pred"))
    r.update(_conv(f"{hd}.centerness", "head/centerness"))
    for lv in range(5):     # flax (), torch (1,): reshaped to torch's shape
        r[f"{hd}.scales.{lv}.scale"] = (f"head/scale_{lv}/scale", None)
    r.update(_linear(f"{hd}.dot_product_projection_text",
                     "head/dot_product_projection_text"))
    for name in ("log_scale", "bias_lang", "bias0"):
        r[f"{hd}.{name}"] = (f"head/{name}", None)
    return r


def rules(cfg: GLIPConfig = GLIPConfig()) -> dict:
    return build_rules(depths=cfg.swin.depths, num_convs=cfg.num_convs,
                       bert_layers=cfg.bert.layers)


def state_dict_from_flax(params: dict, cfg: GLIPConfig = GLIPConfig()) -> dict:
    """The JAX package's flax GLIP params -> the port's state dict."""
    return weights.state_dict_from_flax(
        params, rules(cfg), weights.shapes_of(lambda: GLIPModel(cfg)))


def random_state_dict(net, seed: int = 0) -> dict:
    """A seeded random state dict for a GLIP model (or one of its modules)
    at a deep net's scale (priors.weights.random_state_dict with
    std=None), the head's scalars set where a trained head holds them: the
    bbox Scales near 1, bias0 the focal prior, log_scale -3.5 (a sharp
    token head, so that some class scores pass the 0.05 pre-NMS
    threshold)."""
    import torch

    from fusionsense_tpu_torch.detection.head import PRIOR_BIAS

    sd = weights.random_state_dict(net, seed=seed, std=None)
    for k in sd:
        if k.endswith(".scale"):
            sd[k] = 1.0 + 0.1 * sd[k]
        elif k.endswith("bias0"):
            sd[k] = torch.full_like(sd[k], PRIOR_BIAS)
        elif k.endswith("log_scale"):
            sd[k] = torch.full_like(sd[k], -3.5)
    return sd


def load_glip_checkpoint(path: str, cfg: GLIPConfig = GLIPConfig()) -> GLIPModel:
    """A GLIP checkpoint file -> the port's model on the CPU, in eval mode.
    Unwrapped as the JAX converter does (`ckpt["model"]` when present,
    "module." taken off, the keys the model lacks skipped); a key the model
    needs and the file lacks raises."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return weights.load_filtered(GLIPModel(cfg), state,
                                 strip=("module.",)).eval()
