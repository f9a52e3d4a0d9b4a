"""Work counted from shapes: a model family's FLOPs a training step
(``<family>.py``, for ``mfu_pct``), the port's kernels' operations and
bytes (``kernels.py``), and a kernel set's least time a step in a family
(``<set>/<family>.py``, for the sets' rooflines)."""
