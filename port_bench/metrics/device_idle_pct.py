"""The share of the profiled stretch's span in which no kernel, memcpy
or memset ran on the card (device busy and span from the same trace)."""


def read(run, suffix=None):
    s = run.stretch
    if s is None or not s.device or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
