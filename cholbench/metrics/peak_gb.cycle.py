"""peak_gb.cycle: torch.cuda.max_memory_allocated() over the window (GB,
1e9 bytes): the budget plan and the device memory it leaves. Moves
cycle_ms."""


def read(rec):
    if rec.window_peak_bytes is None:
        return None
    return rec.window_peak_bytes / 1e9
