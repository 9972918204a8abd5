"""peak_mem_gb: torch.cuda.max_memory_allocated() from the Trainer's
construction to the window's end, read before any reference work (GB)."""


def read(raw: dict):
    return raw["peak_mem_bytes"] / 1e9
