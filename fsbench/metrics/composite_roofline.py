"""composite_roofline: the least time the H100 needs for the compositing
work of the profiled steps (fsbench/work.py: counted pairs at the FP32 peak,
or the bytes at the HBM peak) over the device time of the compositor's
kernels there (%)."""
from fsbench import work

# K1/K2 (csrc/flat_composite.cu) and K3/K4 (csrc/composite2.cu)
KERNELS = ("fwd_blocks_kernel", "fwd_scan_kernel", "fwd_combine_kernel",
           "bwd_suffix_kernel", "bwd_blocks_kernel", "fwd_chunks_kernel",
           "bwd_chunks_kernel")


def read(raw: dict):
    spent = sum(s for k, s in raw.get("kernel_s", {}).items()
                if k.split("<")[0] in KERNELS)
    if spent <= 0:
        return None
    least = work.least_seconds(raw["ops_per_step"], raw["bytes_per_step"])
    return 100.0 * least * raw["profiled_steps"] / spent
