"""``rows`` measures of ``seq_len`` tokens drawn uniformly from the
configuration's ``num_notes`` ids (int32)."""

from typing import Dict

import torch


def make(traffic: dict, cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    tokens = torch.randint(0, cfg["model"]["num_notes"], (traffic["rows"], traffic["seq_len"]),
                           generator=gen, device=device, dtype=torch.int32)
    return {"tokens": tokens}
