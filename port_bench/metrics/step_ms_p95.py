"""The 95th percentile of the intervals between consecutive step-end
CUDA events over every step of the measured window, the window's
opening event included."""

from port_bench.stats import percentile


def read(run, suffix=None):
    return percentile(run.window.intervals_ms, 95) if run.window.intervals_ms else None
