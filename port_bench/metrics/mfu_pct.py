"""Model FLOPs a step (``work/<family>.py``, forward and backward,
counted from the shapes) times the measured window's steps, over its
seconds and the card's dense TF32 peak (``peaks.json``): the fastest
rate at which the card multiplies float32 inputs."""


def read(run, suffix=None):
    peaks, w = run.peaks, run.window
    if peaks is None or not w.steps:
        return None
    flops = run.cell.module("work").step_flops(run.cell.cfg, run.cell.traffic)
    return 100.0 * flops * w.steps / w.seconds / peaks["tf32_flop_per_s"]
