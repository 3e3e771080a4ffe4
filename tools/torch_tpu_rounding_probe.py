#!/usr/bin/env python3
"""Does the TPU's default matmul precision move the port's soak metric?

    python3 tools/torch_tpu_rounding_probe.py --dataroot data/mn40_scale \\
        --epochs 30 --input_pipeline device --band

Runs ``tools/torch_soak.py`` (the same flags and lines) in this process
with three float32 products of the encoder rounded as XLA rounds them on
a TPU at its default precision, which the JAX package leaves them at: the
operands in bfloat16, the sums in float32.  The port computes them in
float32 on the card, as the JAX package does on a CPU:

* ``a . b`` of the pairwise squared distances
  (``sonet_tpu/ops/pairwise.py`` ``pairwise_sqdist``): the point-to-node
  top-k assignment and the kNN graph of the nodes;
* the one-hot cluster sum of the stacked points
  (``sonet_tpu/nn/encoder.py``: ``einsum("bnm,bnc->bmc", onehot, xs)``);
* the per-point centers, a one-hot product of the cluster means there
  (``einsum("bnm,bmc->bnc", onehot, som_node)``), a gather here.

Everything else (the bfloat16 layers, BatchNorm, pooling, the optimizer)
is the port's as it is.  A diagnostic: nothing in the package changes,
and the soak's band line reads as ``torch_soak.py``'s does.
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_soak  # noqa: E402


def _bf16(t):
    return t.to(torch.bfloat16).float()


def rounded_sqdist(a, b):
    """``pairwise_sqdist`` with its product's operands in bfloat16."""
    a, b = a.float(), b.float()
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    ab = torch.matmul(_bf16(a), _bf16(b).transpose(-1, -2))
    return torch.clamp_min(a2 + b2.transpose(-1, -2) - 2.0 * ab, 0.0)


class RoundingTorch:
    """``torch`` as the encoder module sees it: ``bmm`` (the cluster sum,
    the encoder's only one) takes its point operand in bfloat16, and the
    ``gather`` that follows it (the centers) gathers bfloat16-rounded
    means; everything else is ``torch``'s.  It checks what it rounds
    against the shapes the encoder gives those two calls, and raises when
    the encoder no longer makes them so (``calls`` counts them)."""

    def __init__(self):
        self._means_shape = None
        self.calls = {"bmm": 0, "centers": 0}

    def bmm(self, onehot_t, points):
        b, m, r = onehot_t.shape
        if points.shape[:2] != (b, r) or self._means_shape is not None:
            raise RuntimeError("rounding probe: the encoder's bmm is no "
                               "longer the one-hot cluster sum")
        self._means_shape = (b, m, points.shape[2])
        self.calls["bmm"] += 1
        return torch.bmm(onehot_t, _bf16(points))

    def gather(self, source, dim, index, *args, **kwargs):
        if self._means_shape is not None:
            if dim != 1 or tuple(source.shape) != self._means_shape:
                raise RuntimeError("rounding probe: the gather after the "
                                   "cluster sum is no longer the centers'")
            self._means_shape = None
            self.calls["centers"] += 1
            source = _bf16(source)
        return torch.gather(source, dim, index, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(torch, name)


@contextlib.contextmanager
def installed():
    """The three products rounded while the block runs; yields the
    encoder's ``RoundingTorch``."""
    from sonet_torch.nn import encoder
    from sonet_torch.ops import pairwise
    saved = pairwise.pairwise_sqdist, encoder.torch
    pairwise.pairwise_sqdist = rounded_sqdist
    encoder.torch = RoundingTorch()
    try:
        yield encoder.torch
    finally:
        pairwise.pairwise_sqdist, encoder.torch = saved


def main(argv=None):
    with installed():
        print("rounding as a TPU at default precision: pairwise a.b, the "
              "cluster sum and the centers in bfloat16", flush=True)
        torch_soak.main(argv)


if __name__ == "__main__":
    main()
