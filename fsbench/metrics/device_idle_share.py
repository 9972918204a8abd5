"""device_idle_share: the share of a step in which the device runs
nothing (%): 1 - the union of the device's kernel, copy and fill intervals
per step of the profiled interval (set-up's last, device_step_ms) over
the step time of the run's unprofiled window (wall_step_ms). The profiler
stretches the host's side of a step, not the device's, so the busy time
comes from the trace and the step time from the window."""


def read(raw: dict):
    if "busy_s" not in raw:
        return None
    busy = raw["busy_s"] / raw["profiled_steps"]
    return 100.0 * (1.0 - busy / (raw["window_s"] / raw["window_steps"]))
