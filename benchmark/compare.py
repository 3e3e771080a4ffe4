"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each a relative gap.

Training (the checked steps of the run, driven through the window's own
call: a first step from the start on each of several batches, the state
put back after each, then a run of steps): ``loss_gap``, the mean over
the first steps of the relative gap of the loss (one first step's gap is
a signed error that lands near 0 on some seeds whatever the precision;
the later steps' losses follow Adam's first, sign-like update of every
weight, which parts two runs a float32 ulp apart); ``grad_median_gap``,
the median over the leaves of the gap between the norms of the first
step's gradient (the program's read back from its optimizer's state:
Adam's first moment after one step is (1 - beta1) times the gradient);
``head_grad_gap``, the relative norm of the difference of that gradient
over the head's leaves; ``change_worst_gap``, the worst leaf's gap
between the norms of each parameter's change after the run.  A leaf's
gap is measured against the larger of the reference's norm of that leaf
and of the median leaf.  A cell's limits file names the numbers it
compares.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out: their true gradient is zero (a bias that a BatchNorm or a later
BatchNorm cancels) and Adam moves them by round-off alone.

Serving: ``logit_gap``, the largest over the answers of the largest gap
of a logit from the reference's, relative to the reference's largest
logit magnitude for that cloud.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

NEGLIGIBLE = 1e-3          # of the median leaf's gradient norm


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in d.items()}


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves compared: a reference gradient of at least NEGLIGIBLE
    times the median leaf's."""
    norms = _norms(ref_grad)
    med = float(torch.tensor(list(norms.values())).median())
    return [n for n, v in norms.items() if v >= NEGLIGIBLE * med]


def leaf_gaps(prog: Dict[str, Optional[torch.Tensor]],
              ref: Dict[str, torch.Tensor], leaves: List[str]
              ) -> Dict[str, float]:
    """{leaf: | |prog| - |ref| | / max(|ref|, median |ref|)} over ``leaves``;
    a leaf the program does not have (None) has norm 0."""
    ref_n = {n: float(ref[n].double().norm()) for n in leaves}
    med = float(torch.tensor(list(ref_n.values())).median())
    out = {}
    for n in leaves:
        p = prog.get(n)
        pn = 0.0 if p is None else float(p.double().norm())
        out[n] = (abs(pn - ref_n[n]) / max(ref_n[n], med)
                  if math.isfinite(pn) else math.inf)
    return out


def leaf_gap(prog, ref, leaves) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, leaves).values())


def head_grad_gap(prog: Dict[str, Optional[torch.Tensor]],
                  ref: Dict[str, torch.Tensor], leaves: List[str]) -> float:
    """| prog - ref | / | ref | of the first gradient over the head's leaves
    among ``leaves`` (the classifier's or segmenter's layers, everything
    outside ``encoder.``), taken together; a leaf the program does not
    have counts as zeros."""
    head = [n for n in leaves if not n.startswith("encoder.")]
    diff = ref_sq = 0.0
    for n in head:
        r = ref[n].double()
        p = prog.get(n)
        p = torch.zeros_like(r) if p is None else p.double()
        diff += float((p - r).square().sum())
        ref_sq += float(r.square().sum())
    return math.sqrt(diff / ref_sq) if math.isfinite(diff) else math.inf


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"first_losses": [float], "grad": {name:
    tensor}, "change": {name: tensor}} of the same checked steps
    (``reference.train.checked_steps``)."""
    leaves = kept_leaves(ref["grad"])
    loss = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(prog["first_losses"], ref["first_losses"])]
    grad = list(leaf_gaps(prog["grad"], ref["grad"], leaves).values())
    return {"loss_gap": sum(loss) / len(loss),
            "grad_median_gap": float(torch.tensor(grad).median()),
            "head_grad_gap": head_grad_gap(prog["grad"], ref["grad"], leaves),
            "change_worst_gap": leaf_gap(prog["change"], ref["change"],
                                         leaves)}


def logit_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """``served`` and ``ref``: (n, classes) logits of the same clouds."""
    served, ref = served.double(), ref.double()
    if not torch.isfinite(served).all():
        return math.inf
    scale = ref.abs().amax(1).clamp_min(1e-12)
    return float(((served - ref).abs().amax(1) / scale).max())
