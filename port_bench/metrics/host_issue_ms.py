"""Host milliseconds a step of the measured window: the benchmark's own
host spans around each step, its gather and its ``train_step`` call
(``harness.Driver``), summed over the window's steps and divided by
their count. A span holds any wait for a full launch queue, so where
the card paces the loop it reads close to the step."""


def read(run, suffix=None):
    w = run.window
    return 1e3 * w.host_s / w.steps if w.steps else None
