"""Cross-modal early fusion (VLFuse / bi-directional multi-head attention).

Counterpart of fusionsense_tpu/detection/fusion.py, with the published
checkpoint's module names (reference PartSlip/GLIP/maskrcnn_benchmark/
utils/fuse_helper.py:171-427, BiMultiHeadAttention and
BiAttentionBlockForCheckpoint as `b_attn`): all FPN levels flattened into
one visual sequence, one joint attention, layer-scale residuals on the
normed inputs. The visual softmax is masked by the language mask; the
language softmax over image positions is unmasked but max-stabilised; the
logits are clamped to +-50,000 before either.
"""
from __future__ import annotations

import torch
from torch import nn

V_DIM = 256       # joint embedding size (visual)
L_DIM = 768       # language dim
EMBED = 2048      # fused attention dim
HEADS = 8
CLAMP = 50000.0


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int = V_DIM, l_dim: int = L_DIM,
                 embed: int = EMBED):
        super().__init__()
        self.embed = embed
        self.v_proj = nn.Linear(v_dim, embed)
        self.l_proj = nn.Linear(l_dim, embed)
        self.values_v_proj = nn.Linear(v_dim, embed)
        self.values_l_proj = nn.Linear(l_dim, embed)
        self.out_v_proj = nn.Linear(embed, v_dim)
        self.out_l_proj = nn.Linear(embed, l_dim)

    def forward(self, v, l, l_mask):
        # v: (Nv, v_dim), l: (Nl, l_dim), l_mask: (Nl,)
        E = self.embed
        hd = E // HEADS

        def heads(t):
            return t.reshape(-1, HEADS, hd).transpose(0, 1)

        q = heads(self.v_proj(v) * (hd ** -0.5))
        k = heads(self.l_proj(l))
        vv = heads(self.values_v_proj(v))
        vl = heads(self.values_l_proj(l))

        attn = torch.clamp(q @ k.transpose(1, 2), -CLAMP, CLAMP)  # (h, Nv, Nl)

        # language->image attention: transpose, stabilise, softmax (unmasked)
        attn_l = attn.transpose(1, 2)
        attn_l = attn_l - torch.amax(attn_l, dim=-1, keepdim=True)
        attn_l = torch.softmax(torch.clamp(attn_l, -CLAMP, CLAMP), dim=-1)

        # image->language attention: mask padded tokens
        attn_v = torch.softmax(
            attn + torch.where(l_mask > 0, 0.0, -9e15)[None, None, :], dim=-1)

        out_v = (attn_v @ vl).transpose(0, 1).reshape(-1, E)
        out_l = (attn_l @ vv).transpose(0, 1).reshape(-1, E)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """Pre-LN bi-attention with layer-scale residuals (gamma init 1/8)."""

    def __init__(self, v_dim: int = V_DIM, l_dim: int = L_DIM,
                 embed: int = EMBED, init_values: float = 1.0 / 8.0):
        super().__init__()
        self.gamma_v = nn.Parameter(torch.full((v_dim,), init_values))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), init_values))
        self.layer_norm_v = nn.LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = nn.LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed)

    def forward(self, v, l, l_mask):
        vn = self.layer_norm_v(v)
        ln = self.layer_norm_l(l)
        dv, dl = self.attn(vn, ln, l_mask)
        # the reference residual base is the NORMED tensor, not the raw
        # input (fuse_helper.py single_attention_call:419-426)
        return vn + self.gamma_v * dv, ln + self.gamma_l * dl


class VLFuse(nn.Module):
    """Flatten all FPN levels -> one joint bi-attention -> unflatten."""

    def __init__(self, v_dim: int = V_DIM, l_dim: int = L_DIM,
                 embed: int = EMBED):
        super().__init__()
        self.b_attn = BiAttentionBlock(v_dim, l_dim, embed)

    def forward(self, feats, lang, l_mask):       # feats: [(C, h, w)]
        sizes = [f.shape[1:] for f in feats]
        flat = torch.cat([f.flatten(1).T for f in feats], 0)
        new_v, new_l = self.b_attn(flat, lang, l_mask)
        out, start = [], 0
        for (h, w) in sizes:
            out.append(new_v[start:start + h * w].T.reshape(-1, h, w))
            start += h * w
        return out, new_l
