"""Method presets: the reference's registered method specifications.

Counterpart of fusionsense_tpu/presets.py, field for field: `splatfacto`
(vanilla 3DGS, no priors), `dn_splatter` (the reference's quality default),
`dn_splatter_big` (higher capacity, longer schedule) and `fusionsense` (the
full schedule of the FusionSense pipeline). Each takes the rasterizer
backend ("jax", "pallas" or "flat").
"""
from __future__ import annotations

from fusionsense_tpu_torch.config import (
    ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
)
from fusionsense_tpu_torch.gaussians.adc import ADCConfig
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig


def _base_raster(backend: str = "jax") -> RasterizeConfig:
    return RasterizeConfig(tile_size=16, tile_capacity=512,
                           max_tiles_per_gaussian=16, backend=backend)


def splatfacto(backend="jax") -> ExperimentConfig:
    """Vanilla 3DGS: RGB loss only, no priors, no binary opacities."""
    return ExperimentConfig(
        model=ModelConfig(rasterize=_base_raster(backend),
                          binary_opacities=False),
        train=TrainConfig(iterations=30_000,
                          adc=ADCConfig(stop_split_at=15_000)),
        loss=LossConfig(normal_lambda=0.0, sensor_depth_lambda=0.0,
                        mono_depth_lambda=0.0, smooth_lambda=0.0,
                        flatness_lambda=0.0),
        experiment_name="splatfacto",
    )


def dn_splatter(backend="jax") -> ExperimentConfig:
    """Depth + normal regularised splatting; the LossConfig defaults are the
    reference's weights."""
    return ExperimentConfig(
        model=ModelConfig(rasterize=_base_raster(backend),
                          binary_opacities=True),
        train=TrainConfig(iterations=15_000,
                          adc=ADCConfig(warmup=500, stop_split_at=10_000)),
        loss=LossConfig(),
        experiment_name="dn_splatter",
    )


def dn_splatter_big(backend="jax") -> ExperimentConfig:
    """Higher capacity and a longer schedule."""
    base = dn_splatter(backend)
    return ExperimentConfig(
        model=ModelConfig(rasterize=_base_raster(backend),
                          binary_opacities=True, capacity=2 ** 20),
        train=TrainConfig(iterations=30_000,
                          adc=ADCConfig(warmup=500, stop_split_at=20_000,
                                        densify_grad_thresh=0.004)),
        loss=base.loss,
        experiment_name="dn_splatter_big",
    )


def fusionsense(backend="jax") -> ExperimentConfig:
    """The full FusionSense schedule: 15k steps, splits stop at 10k, warmup
    500, touch add at 1k, binary opacities, normal 0.4 / sensor depth 0.2 /
    smooth 0.1 / touch 1.0."""
    return ExperimentConfig(
        model=ModelConfig(rasterize=_base_raster(backend),
                          binary_opacities=True),
        train=TrainConfig(iterations=15_000, add_touch_at=1_000,
                          adc=ADCConfig(warmup=500, stop_split_at=10_000)),
        loss=LossConfig(normal_lambda=0.4, sensor_depth_lambda=0.2,
                        mono_depth_lambda=0.2, smooth_lambda=0.1,
                        touch_normal_lambda=1.0),
        experiment_name="fusionsense",
    )


PRESETS = {
    "splatfacto": splatfacto,
    "dn-splatter": dn_splatter,
    "dn-splatter-big": dn_splatter_big,
    "fusionsense": fusionsense,
}
