"""BERT-base language backbone of the grounded detector (inference only).

Counterpart of fusionsense_tpu/detection/bert.py, with HF BERT's module
names, which the published checkpoint carries (reference PartSlip/GLIP/
maskrcnn_benchmark/modeling/language_backbone/bert_model.py:10-79; 12
post-LN layers, hidden 768, heads 12, intermediate 3072, eps 1e-12). Only
the final hidden states flow into the head. The VLDyHead tower interleaves
standalone layers with attention logits clamped to +-clamp
(rpn/vldyhead.py:236-288); `BertLayer(clamp=...)` covers both uses. Padded
tokens are masked with an additive -1e9.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    eps: float = 1e-12


def attention_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """(T,) 0/1 mask -> (1, 1, T) additive bias: 0 kept, -1e9 padded."""
    return torch.where(attention_mask > 0, 0.0, -1e9)[None, None, :]


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, clamp: float = 0.0):
        super().__init__()
        self.cfg, self.clamp = cfg, clamp
        self.query = nn.Linear(cfg.hidden, cfg.hidden)
        self.key = nn.Linear(cfg.hidden, cfg.hidden)
        self.value = nn.Linear(cfg.hidden, cfg.hidden)

    def forward(self, x, attn_bias):
        c = self.cfg
        hd = c.hidden // c.heads

        def heads(t):
            return t.reshape(-1, c.heads, hd).transpose(0, 1)

        logits = heads(self.query(x)) @ heads(self.key(x)).transpose(1, 2) / (
            hd ** 0.5)
        if self.clamp > 0:
            logits = torch.clamp(logits, -self.clamp, self.clamp)
        attn = torch.softmax(logits + attn_bias, dim=-1)
        return (attn @ heads(self.value(x))).transpose(0, 1).reshape(
            -1, c.hidden)


class DenseNorm(nn.Module):
    """HF's output blocks: `dense`, then LayerNorm of the residual sum."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, y, residual):
        return self.LayerNorm(residual + self.dense(y))


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, clamp: float = 0.0):
        super().__init__()
        self.self = BertSelfAttention(cfg, clamp)
        self.output = DenseNorm(cfg.hidden, cfg.hidden, cfg.eps)

    def forward(self, x, attn_bias):
        return self.output(self.self(x, attn_bias), x)


class Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden, cfg.intermediate)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    """Post-LN transformer layer (HF BERT structure)."""

    def __init__(self, cfg: BertConfig, clamp: float = 0.0):
        super().__init__()
        self.attention = BertAttention(cfg, clamp)
        self.intermediate = Intermediate(cfg)
        self.output = DenseNorm(cfg.intermediate, cfg.hidden, cfg.eps)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        return self.output(self.intermediate(x), x)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embeddings = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.hidden)
        self.LayerNorm = nn.LayerNorm(cfg.hidden, eps=cfg.eps)

    def forward(self, input_ids):
        L = input_ids.shape[0]
        x = (self.word_embeddings.weight[input_ids]
             + self.position_embeddings.weight[:L]
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class BertStack(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.layers))


class BertEncoder(nn.Module):
    """Embeddings + layers -> final hidden states (seq, hidden)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertStack(cfg)

    def forward(self, input_ids, attention_mask):
        x = self.embeddings(input_ids)
        bias = attention_bias(attention_mask)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x
