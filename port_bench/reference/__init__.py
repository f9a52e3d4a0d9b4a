"""Plain PyTorch references of the cells' training steps.

Each ``<family>.py`` follows a configuration's first training steps from
the inputs and weights the benchmark made: the rows each step takes,
the step's random draws, the forward, the loss, autograd's gradient and
Adam's update, in float32 with TF32 off (``tf32=True`` gives the
control). Nothing here imports the port (``arvae_tpu_torch``), ``jax``
or the JAX package.
"""
