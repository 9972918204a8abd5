"""Default-device resolution: the port runs on the card unless asked not to."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """torch.device for an entry point's `device=` argument.

    None means the card. Asking for CUDA where no card is visible raises:
    the port never continues on the CPU unless the caller asked for it.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fusionsense_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain CPU path explicitly")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise if any named tensor lies on another device than `device`."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} is on {t.device}, expected {device}")


def device_vector(values, device, dtype=torch.float32) -> torch.Tensor:
    """A short constant vector made by fills on the device. Unlike
    torch.tensor(values, device=...), it copies nothing from the host, so
    it makes no host sync and can be captured in a CUDA graph."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out
