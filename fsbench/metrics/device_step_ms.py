"""device_step_ms: the card's busy time per training step (ms): the union
of its kernel, copy and fill intervals over the refine interval that
follows the warm boundary, traced by torch.profiler at the end of set-up,
over that interval's steps. What a step of the loop costs the card, and
the least time a step could take once the host keeps up with it. None
where the trace holds no device interval (no card)."""


def read(raw: dict):
    if raw.get("busy_s", 0.0) <= 0.0:
        return None
    return 1e3 * raw["busy_s"] / raw["profiled_steps"]
