"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's.

The numbers, of which a configuration's ``limits`` name the ones its
cell compares, each with its limit:

- ``loss_gap``: the largest relative gap of a step's loss,
  |loss − loss_ref| / |loss_ref|, over the checked steps;
- ``grad_gap``: the first gradient as Adam got it (its first moment
  after one step over 1 − β1) against the reference's, by the worst
  leaf: |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖);
  ``grad_gap_median``: the same measure's median over the leaves;
- ``update_gap``: the parameters' change over the checked steps, by the
  worst leaf in the same measure, over the leaves whose reference first
  gradient is at least a thousandth of the median leaf's (a leaf whose
  gradient is nought to rounding moves under Adam by round-off alone);
  ``update_gap_median``: the same measure's median over those leaves;
- ``token_gap``: for a decoder that feeds its own samples back, the
  widest gap by which a token the program fed lies below the reference's
  best logit (the reference follows the program's tokens and judges
  them; a teacher-forced step's tokens must be the score's);
- ``logit_gap``: the widest gap between the program's output head and
  the reference's at the first step (the same weights, inputs and
  draws), over the reference's largest output.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from port_bench.reference.common import Steps

STILL_LEAF = 1e-3  # a leaf's share of the median gradient norm below which it is left out


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in t.items()}


def leaf_gaps(mine: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """{leaf: |mine − ref| / max(ref, the median leaf's ref)} over ``keys``."""
    keys = list(keys)
    median = sorted(ref[k] for k in keys)[len(keys) // 2]
    return {k: abs(mine[k] - ref[k]) / max(ref[k], median) for k in keys}


def gap_maps(program: Steps, reference: Steps, start: Dict[str, torch.Tensor]):
    """(loss gap, {leaf: first-gradient gap}, {moving leaf: change gap})."""
    if set(program.params) != set(reference.params):
        raise ValueError("the program's leaves are not the reference's: "
                         f"{sorted(set(program.params) ^ set(reference.params))}")
    loss = math.inf
    if len(program.losses) == len(reference.losses):
        loss = max(abs(a - b) / abs(b) for a, b in zip(program.losses, reference.losses))
    g, g_ref = _norms(program.grad1), _norms(reference.grad1)
    median_g = sorted(g_ref.values())[len(g_ref) // 2]
    moving = [k for k in g_ref if g_ref[k] >= STILL_LEAF * median_g]
    d = _norms({k: program.params[k] - start[k] for k in moving})
    d_ref = _norms({k: reference.params[k] - start[k] for k in moving})
    return loss, leaf_gaps(g, g_ref, g_ref), leaf_gaps(d, d_ref, moving)


def median(gaps: Dict[str, float]) -> float:
    return statistics.median(gaps.values())


def readings(program: Steps, reference: Steps, start: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
    """The three numbers of one run; ``start`` holds the initial weights."""
    loss, grad, update = gap_maps(program, reference, start)
    return {"loss_gap": loss, "grad_gap": max(grad.values()), "grad_gap_median": median(grad),
            "update_gap": max(update.values()), "update_gap_median": median(update),
            "token_gap": reference.token_gap, "logit_gap": logit_gap(program, reference)}


def logit_gap(program: Steps, reference: Steps) -> float:
    """The widest gap between the program's and the reference's output
    head at the first step, over the reference's largest output (0 for a
    model whose head is not recorded)."""
    if not program.logits or not reference.logits:
        return 0.0
    a, b = program.logits[0].double(), reference.logits[0].double()
    if a.shape != b.shape:
        return math.inf
    return float((a - b).abs().max() / b.abs().max())


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """(every number ``limits`` names within its limit, one line a
    number); a NaN fails."""
    lines = [f"{n} {values[n]!r} limit {limits[n]!r}" for n in limits]
    return all(values[n] <= limits[n] for n in limits), lines
