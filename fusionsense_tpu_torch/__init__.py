"""PyTorch/CUDA port of fusionsense_tpu for NVIDIA Hopper (H100).

The package mirrors fusionsense_tpu's module layout so each counterpart is
easy to find. It imports torch and numpy only: never jax, never anything of
fusionsense_tpu. Plain tensor code stands in for the JAX package's XLA code;
each Pallas kernel on the ported path is a hand-written CUDA kernel under
csrc/, built with nvcc at first use (kernels/build.py) and bound with ctypes.

Entry points (Trainer, rasterize, the synthetic scene makers) run on "cuda"
unless the caller passes device="cpu"; with no card they raise instead of
falling back.
"""
from fusionsense_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
