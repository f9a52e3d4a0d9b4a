"""Samples stepped in the measured window over its seconds (host clock;
the window ends with a synchronise)."""


def read(run, suffix=None):
    w = run.window
    return w.steps * w.batch / w.seconds if w.steps else None
