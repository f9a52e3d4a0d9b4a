"""Seconds from the process's start to the first timed step: imports,
data and weights, the trainer, the first build of the port's libraries
where the checkout has none, the checked and warm-up steps."""


def read(run, suffix=None):
    return run.setup_s
