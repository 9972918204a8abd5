"""refine_ms: mean device-side milliseconds of a refine boundary
(Trainer.refine_boundary: ADC refine, callbacks, recompaction), CUDA events
around each boundary of the traced run's window."""


def read(raw: dict):
    ms = raw.get("refine_ms") or []
    return sum(ms) / len(ms) if ms else None
