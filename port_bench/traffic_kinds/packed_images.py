"""``rows`` bit-packed ``height`` x ``width`` images of uniform random
bits (uint8, 8 pixels a byte, MSB first) and their labels, one column a
factor, each drawn uniformly from its grid ``[start, stop, count]``
(float32)."""

from typing import Dict

import torch


def make(traffic: dict, cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    n_bytes = traffic["height"] * traffic["width"] // 8
    packed = torch.randint(0, 256, (traffic["rows"], n_bytes), generator=gen, device=device,
                           dtype=torch.uint8)
    columns = []
    for start, stop, count in traffic["label_factors"]:
        idx = torch.randint(0, count, (traffic["rows"],), generator=gen, device=device)
        step = (stop - start) / (count - 1) if count > 1 else 0.0
        columns.append(start + idx.to(torch.float64) * step)
    labels = torch.stack(columns, dim=1).to(torch.float32)
    return {"packed": packed, "labels": labels}
