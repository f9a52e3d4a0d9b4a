"""The generators of the cells' inputs, one module a traffic ``kind``:
``<kind>.py``'s ``make(traffic, cfg, gen, device)`` returns the cell's
data set, drawn from ``gen`` on ``device`` (``data.make_inputs``)."""
