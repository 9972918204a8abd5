"""LPIPS (VGG-16 variant) as a torch module — the in-repo perceptual metric.

Counterpart of fusionsense_tpu/eval/lpips_jax.py, the published LPIPS v0.1
"vgg" net: ScalingLayer normalisation, VGG-16 features at relu1_2, 2_2,
3_3, 4_3 and 5_3, unit normalisation over channels, squared difference,
learned 1x1 linear heads, spatial mean, sum over the five layers.

Weights-gated: it reads the same .npz that the JAX package's
load_lpips_params reads (convert_lpips_weights maps the torch state dicts
of torchvision's VGG-16 `features.*` and LPIPS's `lin*.model.1.weight`
onto its flat keys), so one converted file serves both packages. No
weights are downloaded. The convolutions are torch.nn.functional.conv2d,
as the JAX package leaves them to lax.conv outside any kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG-16 feature indices of the conv layers in each slice
VGG_SLICES = (
    ((0, 64), (2, 64)),
    ((5, 128), (7, 128)),
    ((10, 256), (12, 256), (14, 256)),
    ((17, 512), (19, 512), (21, 512)),
    ((24, 512), (26, 512), (28, 512)),
)

# LPIPS ScalingLayer constants (lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSVGG(torch.nn.Module):
    """The LPIPS VGG net from a params dict of the .npz layout:
    conv{s}_{c}/kernel (3, 3, in, out), conv{s}_{c}/bias and lin{s} (C,)."""

    def __init__(self, params: dict):
        super().__init__()
        self.convs = torch.nn.ParameterList()
        self.slices = []
        for si, slice_convs in enumerate(VGG_SLICES):
            names = []
            for ci in range(len(slice_convs)):
                p = params[f"conv{si}_{ci}"]
                w = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
                self.convs.append(torch.nn.Parameter(
                    torch.from_numpy(w.copy()), requires_grad=False))
                self.convs.append(torch.nn.Parameter(
                    torch.from_numpy(np.asarray(p["bias"], np.float32).copy()),
                    requires_grad=False))
                names.append(len(self.convs) - 2)
            self.slices.append(names)
        self.lins = torch.nn.ParameterList([
            torch.nn.Parameter(torch.from_numpy(
                np.asarray(params[f"lin{si}"], np.float32).copy()),
                requires_grad=False) for si in range(len(VGG_SLICES))])
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        """(1, 3, H, W) scaled input -> the five slice outputs (post-ReLU)."""
        outs = []
        for si, names in enumerate(self.slices):
            for k in names:
                x = F.relu(F.conv2d(x, self.convs[k], self.convs[k + 1],
                                    padding=1))
            outs.append(x)
            if si < len(self.slices) - 1:
                x = F.max_pool2d(x, 2, 2)   # 2x2 max pool, stride 2
        return outs

    @staticmethod
    def _unit_norm(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
        return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) pair in [0, 1] -> the scalar LPIPS distance."""
        def prep(x):
            x = x.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0
            return (x - self.shift) / self.scale

        f0, f1 = self.features(prep(img0)), self.features(prep(img1))
        total = torch.zeros((), device=img0.device)
        for si in range(len(self.slices)):
            d = (self._unit_norm(f0[si]) - self._unit_norm(f1[si])) ** 2
            total = total + torch.mean(torch.sum(
                d * self.lins[si][None, :, None, None], dim=1))
        return total


def convert_lpips_weights(vgg_state: dict, lpips_state: dict) -> dict:
    """torchvision VGG-16 `features.*` + LPIPS `lin{k}` state dicts ->
    params of the .npz layout. Accepts tensors or ndarrays."""
    def arr(v):
        return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                          else v, np.float32)

    params: dict = {}
    for si, slice_convs in enumerate(VGG_SLICES):
        for ci, (idx, _c) in enumerate(slice_convs):
            params[f"conv{si}_{ci}"] = {
                "kernel": arr(vgg_state[f"features.{idx}.weight"])
                .transpose(2, 3, 1, 0),
                "bias": arr(vgg_state[f"features.{idx}.bias"]),
            }
    for si in range(5):
        # lpips lin heads: (1, C, 1, 1) conv kernels, no bias
        for key in (f"lin{si}.model.1.weight", f"lins.{si}.model.1.weight"):
            if key in lpips_state:
                params[f"lin{si}"] = arr(lpips_state[key])[0, :, 0, 0]
                break
        else:
            raise KeyError(f"lin{si} head missing from LPIPS state dict")
    return params


def load_lpips_params(path) -> dict:
    """Params saved by save_lpips_params (the .npz of both packages)."""
    params: dict = {}
    with np.load(path) as z:
        for k in z.files:
            node = params
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
    return params


def save_lpips_params(path, params: dict) -> None:
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = np.asarray(v)

    walk("", params)
    np.savez(path, **flat)
