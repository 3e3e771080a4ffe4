#!/usr/bin/env python3
"""Does the TPU's default matmul precision move the port's soak metric?

    python3 tools/torch_tpu_rounding_probe.py --dataroot data/mn40_scale \\
        --epochs 30 --input_pipeline device --band \\
        [--round pairwise cluster som head | all | knnmax] \
        [--refit_som]

Runs ``tools/torch_soak.py`` (the same flags and lines) in this process
with float32 products that the JAX package leaves at XLA's default
precision rounded as XLA rounds them on a TPU there: the operands in
bfloat16, the sums in float32.  The port computes them in float32 on the
card, as the JAX package does on a CPU.  ``--round`` picks them (default
``pairwise cluster``, the three products of the encoder):

* ``pairwise``: ``a . b`` of the pairwise squared distances
  (``sonet_tpu/ops/pairwise.py`` ``pairwise_sqdist``, ``:36``): the
  point-to-node top-k assignment and the kNN graph of the nodes;
* ``cluster``: the one-hot cluster sum of the stacked points
  (``sonet_tpu/nn/encoder.py:173``, ``einsum("bnm,bnc->bmc", onehot,
  xs)``; here a ``bmm`` on the scatter path and ``segment_sums`` on the
  sorted one, the card's) and the per-point centers, a one-hot product of
  the cluster means there (``:179``), a gather here;
* ``som``: ``a . b`` of the distances inside the SOM fit
  (``sonet_tpu/som/som.py:89`` ``batch_update`` and ``:158`` ``query``
  call ``pairwise_sqdist``), which ``prep som`` runs on the TPU for the
  JAX package's datasets; it acts only with ``--refit_som``;
* ``head``: every dense layer without a compute dtype
  (``sonet_tpu/nn/layers.py:166`` ``DenseBN`` and ``:205``
  ``ConcatDense``, and flax's ``nn.Dense``): the float32 ``fc3`` of the
  bfloat16 presets' classifier.

The three one-hot products of pooling's gradient
(``sonet_tpu/ops/segment.py:96``, ``:107``, ``:121``, ``route_max_grad``,
``precision=None`` under bfloat16) are not rounded: their operands are
bfloat16 or 0 / 1 already, so a TPU's default precision changes no bit
of them (``tests/test_torch_quality.py`` checks the operands).

``all`` is all four.  ``knnmax`` is no product's rounding but a
hypothesis about the JAX package's compiled backward of ``KNNModule``'s
max over the K neighbours (``jnp.max``, ``sonet_tpu/nn/layers.py:379``):
its gradient goes to the entries that equal the maximum, and the fused
backward recomputes those entries (the last layer's BatchNorm and
ReLU) in a fusion of its own.  On a CPU in float32 about 8% of the
maxima then match no entry and pass no gradient (``tools/
compare_packages.py``, ``JAX_COMPILES``); if a TPU compiler kept that
recomputation in float32, skipping the bfloat16 rounding that the
forward's maximum went through (excess precision), nearly every
bfloat16 maximum would match none.  ``knnmax`` routes the port's
gradient so: compared with the float32 values.  Only the first PointNet
and the kNN layer learn through that max.  ``--refit_som`` first fits the tree's SOM nodes
again (``prep som`` on ``--device``, 8x8 nodes of ``--som_sample``
points, 4,096 by default, batches of 64, as ``tools/torch_quality.py``
fits them), with the ``som``
rounding when it is chosen and in float32 when not: the nodes stay on
the tree for later runs.

Everything else (the bfloat16 layers, BatchNorm, pooling, the optimizer)
is the port's as it is.  A diagnostic: nothing in the package changes,
and the soak's band line reads as ``torch_soak.py``'s does.
"""

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import torch_soak  # noqa: E402

ROUNDINGS = ("pairwise", "cluster", "som", "head")
DEFAULT = ("pairwise", "cluster")
# not a product's rounding: a hypothesis about the fused backward of
# KNNModule's max over the neighbours (the module docstring)
EXCESS = ("knnmax",)


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
    means; everything else is ``torch``'s.  ``segment_sums``, the sorted
    pipeline's cluster sum, takes its points in bfloat16 as ``bmm`` does
    (``installed`` puts it in the encoder's ``segment_sums``).  It checks
    what it rounds against the shapes the encoder gives those calls, and
    raises when the encoder no longer makes them so (``calls`` counts
    them, either cluster sum as ``bmm``)."""

    def __init__(self, calls=None):
        self._means_shape = None
        self.calls = {} if calls is None else calls
        self.calls.update(bmm=0, centers=0)

    def bmm(self, onehot_t, points):
        b, m, r = onehot_t.shape
        if points.shape[:2] != (b, r) or self._means_shape is not None:
            raise RuntimeError("rounding probe: the encoder's bmm is no "
                               "longer the one-hot cluster sum")
        self._means_shape = (b, m, points.shape[2])
        self.calls["bmm"] += 1
        return torch.bmm(onehot_t, _bf16(points))

    def segment_sums(self, seg_ids, points, num_segments):
        from sonet_torch.ops import segment_sums
        if self._means_shape is not None:
            raise RuntimeError("rounding probe: the encoder's segment_sums "
                               "is no longer the cluster sum")
        counts, sums = segment_sums(seg_ids, _bf16(points), num_segments)
        self._means_shape = tuple(sums.shape)
        self.calls["bmm"] += 1
        return counts, sums

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


class Probe:
    """What ``installed`` rounds: ``calls`` counts each rounding's calls
    by name (``bmm`` and ``centers`` for ``cluster``, else the rounding's
    own name; ``pairwise`` replaces a function and counts nothing)."""

    def __init__(self):
        self.calls = {}


def _som_sqdist(calls):
    from sonet_torch.som import som

    def sqdist(x, nodes):
        calls["som"] += 1
        x, nodes = x.float(), nodes.float()
        x2 = (x * x).sum(-1, keepdim=True)
        n2 = (nodes * nodes).sum(-1)[:, None, :]
        xn = (_bf16(x)[:, :, None, :] * _bf16(nodes)[:, None, :, :]).sum(-1)
        return torch.clamp_min(x2 + n2 - 2.0 * xn, 0.0)

    calls["som"] = 0
    return som, "_sqdist", sqdist


def _head_forwards(calls):
    """Dense and ConcatDense forwards that round both operands of a layer
    without a compute dtype to bfloat16 (sums in float32)."""
    from sonet_torch.nn.layers import ConcatDense, Dense
    dense, concat = Dense.forward, ConcatDense.forward

    def dense_forward(self, x):
        if self.compute_dtype is not None:
            return dense(self, x)
        calls["head"] += 1
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        w, b = self._params(dt)
        return F.linear(_bf16(x.to(dt)), _bf16(w)) + b

    def concat_forward(self, *xs):
        if self.compute_dtype is not None:
            return concat(self, *xs)
        calls["head"] += 1
        w, b = self._params(torch.float32)
        out_rank = max(x.dim() for x in xs)
        y, off = None, 0
        for x, c in zip(xs, self.splits):
            part = F.linear(_bf16(x.float()), _bf16(w[:, off:off + c]))
            for _ in range(out_rank - x.dim()):
                part = part.unsqueeze(1)
            y = part if y is None else y + part
            off += c
        return y + b

    calls["head"] = 0
    return [(Dense, "forward", dense_forward),
            (ConcatDense, "forward", concat_forward)]


class _ExcessMax(torch.autograd.Function):
    """The max over K of ``h`` (bfloat16) whose gradient goes to the
    entries of ``h32`` (the same values before their rounding to
    bfloat16) that equal the maximum, split among them; a maximum that
    no such entry equals passes no gradient."""

    @staticmethod
    def forward(ctx, h, h32):
        ans = h.amax(2, keepdim=True)
        ctx.save_for_backward(h32, ans)
        return ans.squeeze(2)

    @staticmethod
    def backward(ctx, g):
        h32, ans = ctx.saved_tensors
        hit = (h32 == ans.float()).float()
        count = hit.sum(2, keepdim=True)
        grad = g.float()[:, :, None, :] * hit / count.clamp_min(1.0)
        return grad.to(ans.dtype), None


def _knn_max_forward(calls):
    """``KNNModule.forward`` whose max over the K neighbours routes its
    gradient as XLA would if the backward recomputed the last layer's
    output without its rounding to bfloat16 (excess precision) and
    compared it with the forward's bfloat16 maximum."""
    from sonet_torch.nn.layers import KNNModule, knn_gather, recomputation
    plain = KNNModule.forward

    def forward(self, coordinate, x, knn_idx, center_type="avg",
                epoch=None):
        last = getattr(self, f"PointLayer_{self.n - 1}")
        if last.Dense_0.compute_dtype != torch.bfloat16:
            return plain(self, coordinate, x, knn_idx, center_type, epoch)
        calls["knnmax"] += 1
        coordinate = coordinate.detach()
        neighbors = knn_gather(coordinate, knn_idx)
        center = (neighbors.mean(2, keepdim=True) if center_type == "avg"
                  else coordinate[:, :, None, :])
        decentered, x_neighbors = neighbors - center, knn_gather(x, knn_idx)
        dt = torch.promote_types(decentered.dtype, x_neighbors.dtype)
        h = torch.cat([decentered.to(dt), x_neighbors.to(dt)], -1)
        for i in range(self.n - 1):
            h = getattr(self, f"PointLayer_{i}")(h, epoch=epoch)
        pre = last.Dense_0(h)
        out = last.act(last.BatchNorm_0(pre, epoch))
        with torch.no_grad(), recomputation():   # no second stats update
            out32 = last.act(last.BatchNorm_0(pre.float(), epoch))
        return center.squeeze(2), _ExcessMax.apply(out, out32)

    calls["knnmax"] = 0
    return [(KNNModule, "forward", forward)]


@contextlib.contextmanager
def installed(names=DEFAULT):
    """The chosen roundings (``ROUNDINGS``; "all" for every one) in place
    while the block runs; yields the ``Probe``."""
    names = ROUNDINGS if "all" in names else tuple(names)
    unknown = set(names) - set(ROUNDINGS + EXCESS)
    if unknown:
        raise ValueError(f"unknown roundings {sorted(unknown)}")
    from sonet_torch.nn import encoder
    from sonet_torch.ops import pairwise
    probe = Probe()
    patches = []
    if "pairwise" in names:
        patches.append((pairwise, "pairwise_sqdist", rounded_sqdist))
    if "cluster" in names:
        rounding = RoundingTorch(probe.calls)
        patches += [(encoder, "torch", rounding),
                    (encoder, "segment_sums", rounding.segment_sums)]
    if "som" in names:
        patches.append(_som_sqdist(probe.calls))
    if "head" in names:
        patches += _head_forwards(probe.calls)
    if "knnmax" in names:
        patches += _knn_max_forward(probe.calls)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, new in patches:
        setattr(obj, attr, new)
    try:
        yield probe
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)


def refit_som(dataroot, device, rows=8, som_sample=4096):
    """Fit the tree's SOM nodes again as ``tools/torch_quality.py`` does,
    under whatever roundings are installed."""
    from sonet_torch.data import prep
    prep.main(["som", "--root", dataroot, "--rows", str(rows), "--batch",
               "64", "--som_sample", str(som_sample), "--device", device])


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--round", nargs="+", default=list(DEFAULT),
                   choices=ROUNDINGS + EXCESS + ("all",))
    p.add_argument("--refit_som", action="store_true")
    p.add_argument("--som_sample", type=int, default=4096)
    args, rest = p.parse_known_args(argv)
    names = ROUNDINGS if "all" in args.round else tuple(args.round)
    with installed(names) as probe:
        print("rounding as a TPU at default precision: "
              + ", ".join(names) + " in bfloat16", flush=True)
        if args.refit_som:
            q = argparse.ArgumentParser(add_help=False)
            q.add_argument("--dataroot", required=True)
            q.add_argument("--device", default="cuda")
            known, _ = q.parse_known_args(rest)
            refit_som(known.dataroot, known.device,
                      som_sample=args.som_sample)
            print(f"refit the SOM nodes of {known.dataroot}"
                  + (" with the som rounding" if "som" in names else
                     " in float32"), flush=True)
        torch_soak.main(rest)
        print(f"rounding probe calls: {probe.calls}", flush=True)


if __name__ == "__main__":
    main()
