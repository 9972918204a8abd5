"""launches_per_step: CUDA launch calls (kernel and graph launches, copies,
fills) of the profiled interval over its steps. Layer: the host loop."""


def read(raw: dict):
    if "launches" not in raw:
        return None
    return raw["launches"] / raw["profiled_steps"]
