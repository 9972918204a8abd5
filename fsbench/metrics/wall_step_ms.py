"""wall_step_ms: the window's wall time over every step Trainer.run
completed in it, refine boundaries, callbacks and log-boundary reads
included (ms). In a cell whose loop the host sets the pace of, it follows
the host's speed, so it is read per layer there (the host loop)."""


def read(raw: dict):
    return 1e3 * raw["window_s"] / raw["window_steps"]
