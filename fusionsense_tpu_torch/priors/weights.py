"""Weights of the prior nets: checkpoint files, flax parameter trees and
seeded random state dicts.

Each net's parameter and buffer names are the key names of the published
torch checkpoint, so a checkpoint loads with load_state_dict(strict=True)
once unwrapped and filtered to the keys the net has (the keys a published
file carries beyond them, such as DINOv2's mask_token, are the ones the
JAX package's converters skip too). The rule tables in each net's
convert.py map those keys to the JAX package's flax parameter paths, with
a layout `kind` per key; `state_dict_from_flax` inverts them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def conv_from_flax(a):
    """flax conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return np.transpose(a, (3, 2, 0, 1))


def conv_transpose_from_flax(a):
    """flax ConvTranspose kernel (kh, kw, in, out), taps rotated 180 degrees
    by the converter, -> torch ConvTranspose2d (in, out, kh, kw)."""
    return np.transpose(np.asarray(a)[::-1, ::-1], (2, 3, 0, 1))


def linear_from_flax(a):
    """flax Dense kernel (in, out) -> torch Linear (out, in)."""
    return np.transpose(a, (1, 0))


def dense_as_conv1x1(a):
    """flax Dense kernel (in, out) -> torch 1x1 conv (out, in, 1, 1)."""
    return np.transpose(a, (1, 0))[:, :, None, None]


FROM_FLAX = {None: np.asarray, "conv": conv_from_flax,
             "convT": conv_transpose_from_flax, "linear": linear_from_flax,
             "se": dense_as_conv1x1}


def state_dict_from_flax(params: dict, rules: dict, shapes: dict) -> dict:
    """The torch state dict of flax `params` (nested dicts of arrays): for
    each torch key of `rules` ({key: (flax path "a/b/c", kind)}), the flax
    leaf in torch's layout, reshaped to `shapes[key]` (the tokens and
    position embeddings carry a leading batch axis in torch only)."""
    out = {}
    for key, (path, kind) in rules.items():
        node = params
        for p in path.split("/"):
            node = node[p]
        a = np.ascontiguousarray(FROM_FLAX[kind](np.asarray(node, np.float32)))
        out[key] = torch.from_numpy(a.reshape(tuple(shapes[key])))
    return out


def shapes_of(make_net) -> dict:
    """{key: shape} of the net that `make_net()` builds, built on the meta
    device (no memory)."""
    with torch.device("meta"):
        net = make_net()
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def random_state_dict(net: torch.nn.Module, seed: int = 0,
                      std: float | None = 0.05) -> dict:
    """A seeded random state dict for `net`, drawn by a torch.Generator in
    the order of net.state_dict(); BatchNorm running variances from
    U(0.5, 2). With `std`, every other entry from N(0, std). With
    std=None, a deep net's scale: kernels (2 or more axes) from
    N(0, 1 / fan_in), the scales of norms and LayerScale from 1 + N(0,
    0.1), biases and running means from N(0, 0.02), tokens and position
    embeddings from N(0, 0.02)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in net.state_dict().items():
        if k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) * 1.5 + 0.5
            continue
        x = torch.randn(v.shape, generator=g)
        if std is not None:
            out[k] = x * std
        elif v.dim() >= 2 and k.endswith("weight"):
            out[k] = x / math.sqrt(v[0].numel())
        elif k.endswith(("weight", "gamma")):
            out[k] = 1.0 + 0.1 * x
        else:
            out[k] = 0.02 * x
    return out


def load_filtered(net: torch.nn.Module, state: dict,
                  strip=("module.", "model.")) -> torch.nn.Module:
    """Load a checkpoint's `state` into `net` with strict=True, after taking
    each of the `strip` prefixes off the keys and dropping the keys the net
    does not have. A key the net needs and the file lacks raises."""
    want = net.state_dict().keys()
    picked = {}
    for key, value in state.items():
        for p in strip:
            key = key.removeprefix(p)
        if key in want:
            picked[key] = value
    net.load_state_dict(picked, strict=True)
    return net
