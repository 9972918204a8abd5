"""step_mfu: the compositing's counted FP32 operations per step of the
profiled interval over the card's busy time per step there (device_step_ms)
at the H100's FP32 peak (%): the whole step's share of the card's peak,
which bounds the compositor kernels' roofline share."""
from fsbench import work


def read(raw: dict):
    if "ops_per_step" not in raw or raw.get("busy_s", 0.0) <= 0.0:
        return None
    step_s = raw["busy_s"] / raw["profiled_steps"]
    return 100.0 * raw["ops_per_step"] / (step_s * work.PEAK_FP32)
