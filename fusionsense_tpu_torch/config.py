"""Single dataclass config tree, with the JAX package's names and defaults.

Counterpart of fusionsense_tpu/config.py. Options whose code is not ported
yet keep their fields and defaults; the entry points raise when they are
switched on (render/rasterize.check_slice, train/trainer.check_slice).
"""
from __future__ import annotations

import dataclasses

from fusionsense_tpu_torch.gaussians.adc import ADCConfig
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig


@dataclasses.dataclass(frozen=True)
class LossConfig:
    ssim_lambda: float = 0.2
    depth_loss: str = "EdgeAwareLogL1"  # {MSE,L1,LogL1,HuberL1,EdgeAwareLogL1}
    sensor_depth_lambda: float = 0.2
    mono_depth_lambda: float = 0.2
    depth_tolerance: float = 0.1
    smooth_lambda: float = 0.1
    use_depth_smooth_edge_aware: bool = True
    normal_lambda: float = 0.4
    normal_supervision: str = "mono"    # "mono" | "depth" (pseudo-normals)
    use_normal_tv: bool = True
    use_normal_cosine: bool = False
    flatness_lambda: float = 1.0
    sparse_lambda: float = 0.0
    touch_normal_lambda: float = 1.0
    sdf_lambda: float = 0.0
    sdf_samples: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    rasterize: RasterizeConfig = RasterizeConfig()
    binary_opacities: bool = True
    binary_opacity_threshold: float = 0.9
    binary_opacity_margin: int = 200
    background: tuple = (0.0, 0.0, 0.0)
    init_opacity: float = 0.1
    capacity: int = 2 ** 18


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    iterations: int = 15_000
    adc: ADCConfig = ADCConfig()
    add_touch_at: int = 1000
    seed: int = 0
    steps_per_save: int = 15_000
    log_every: int = 100
    scan_chunk: int = 100               # steps per chunk (the bin cache is
    #                                     chunk-local, as in the JAX scan)
    auto_capacity: bool = True
    render_prefix: bool = True
    auto_tile_capacity: bool = True
    max_tile_capacity: int = 2048
    tile_overflow_frac: float = 0.02
    auto_cover_window: bool = True
    cover_trunc_frac: float = 1e-3
    bin_refresh_steps: int = 0
    camera_opt: bool = False
    camera_opt_lr: float = 1e-3
    camera_opt_every_k: int = 100


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    loss: LossConfig = LossConfig()
    output_dir: str = "outputs"
    experiment_name: str = "default"
