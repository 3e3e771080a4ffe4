"""Plain SO-Net (arXiv:1803.04249, lijx10/SO-Net) in float32 PyTorch: the
classifier and the part segmenter, forward and loss, written from the
paper and the reference code for the benchmark's comparison.

Nothing here imports the measured program.  Parameters are a dict of
tensors named as the measured package's ``state_dict`` names them (the
benchmark draws one dict and hands it to both sides); ``param_specs``
lists them from the configuration alone, so a program whose layers
differ fails to load the dict.

Layout is channel-last: a cloud is (B, N, 3).  Per-point layers are
dense maps over the last axis followed, where the network has them, by
BatchNorm over every other axis (batch statistics in training, running
ones in eval) and ReLU.  Everything is float32; ``prec`` rounds the
values where a lower-precision run would round them (the control of the
comparison, ``precision.py``).

Departures from the reference code, each the measured program's
documented semantics and none of them a change to the mathematics of a
step:

* node pooling and the max over the K neighbours split the gradient of a
  tie equally among the tied points (autograd's amax); the global max
  over nodes sends it to the first winner (argmax);
* an empty node takes the feature of stacked point 0;
* the k nearest nodes of a point break distance ties toward the lower
  node index.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

FP32 = Precision("float32")
BN_EPS = 1e-5
NUM_CATEGORIES = 16   # ShapeNetPart shape categories (the label one-hot)

# (name, input widths, output width, BatchNorm and ReLU, rounded like the
# layers that run in the configuration's compute dtype)
Layer = Tuple[str, Tuple[int, ...], int, bool, bool]


def _check(cfg: dict) -> None:
    if cfg["dataset"] == "mnist" or cfg["som_k"] < 2:
        raise NotImplementedError(
            "the reference covers 3-D clouds with the kNN layer (som_k >= 2)")
    if cfg["task"] not in ("classify", "segment"):
        raise NotImplementedError(f"task {cfg['task']!r}")
    if cfg["normalization"] != "batch" or cfg["activation"] != "relu":
        raise NotImplementedError("BatchNorm and ReLU only")
    if not cfg["surface_normal"]:
        raise NotImplementedError("clouds with normals only")


def layers(cfg: dict) -> List[Layer]:
    """Every dense layer of the model, in order."""
    _check(cfg)
    D = 3
    first_in = 2 * D
    F_ = cfg["feature_num"]
    fp = "encoder.first_pointnet.PointLayer_"
    out = [(fp + "0", (first_in,), 64, True, True),
           (fp + "1", (64,), 128, True, True),
           (fp + "2", (128,), 256, True, True),
           (fp + "3", (64, 256), 384, False, True),
           ("encoder.knnlayer.PointLayer_0", (D + 384,), 512, True, True),
           ("encoder.knnlayer.PointLayer_1", (512,), 512, True, True),
           ("encoder.final_pointnet.PointLayer_0", (D + 512,), 768, True,
            True),
           ("encoder.final_pointnet.PointLayer_1", (768,), F_, False, True)]
    if cfg["task"] == "classify":
        out += [("classifier.fc1", (F_,), 512, True, True),
                ("classifier.fc2", (512,), 256, True, True),
                # the last classifier layer runs in float32 in every precision
                ("classifier.fc3", (256,), cfg["classes"], False, False)]
    else:
        widths = (D, D, D, D, NUM_CATEGORIES, 384, 384, 512, F_, F_)
        out += [("segmenter.layer1", widths, 1024, True, True),
                ("segmenter.layer2", (1024,), 512, True, True),
                ("segmenter.layer3", (512,), 256, True, True),
                ("segmenter.layer4", (256,), 128, True, True),
                ("segmenter.layer5", (128,), cfg["classes"], False, True)]
    return out


def param_specs(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{name: (shape, kind)} of every parameter and BatchNorm statistic.
    Kinds: ``weight`` (out, in), ``bias``, ``bn_weight``, ``bn_bias``,
    ``running_mean``, ``running_var``."""
    specs = {}
    for name, ins, out, bn, _ in layers(cfg):
        specs[f"{name}.Dense_0.weight"] = ((out, sum(ins)), "weight")
        specs[f"{name}.Dense_0.bias"] = ((out,), "bias")
        if bn:
            b = f"{name}.BatchNorm_0."
            specs[b + "weight"] = ((out,), "bn_weight")
            specs[b + "bias"] = ((out,), "bn_bias")
            specs[b + "running_mean"] = ((out,), "running_mean")
            specs[b + "running_var"] = ((out,), "running_var")
    return specs


def trainable(specs: dict) -> List[str]:
    """The names of the parameters (not the BatchNorm statistics)."""
    return [n for n, (_, kind) in specs.items()
            if kind not in ("running_mean", "running_var")]


# ---------------------------------------------------------------------------

def _batchnorm(x, p, name, train):
    rows = tuple(range(x.dim() - 1))
    if train:
        mean = x.mean(rows)
        var = (x - mean).square().mean(rows)       # biased, two passes
    else:
        mean = p[name + "running_mean"]
        var = p[name + "running_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[name + "weight"] \
        + p[name + "bias"]


def point_layer(p, spec: Layer, x, train: bool, prec: Precision = FP32):
    """dense -> [BatchNorm -> ReLU] over the last axis of ``x``."""
    name, _, _, bn, rounded = spec
    q = prec.round if rounded else (lambda t: t)
    w, b = p[name + ".Dense_0.weight"], p[name + ".Dense_0.bias"]
    y = q(q(x) @ q(w).t() + q(b))
    if bn:
        y = q(F.relu(q(_batchnorm(y, p, name + ".BatchNorm_0.", train))))
    return y


def sqdist(a, b):
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances."""
    return (a[:, :, None, :] - b[:, None, :, :]).square().sum(-1)


def nearest(d, k):
    """Indices of the k smallest entries of the last axis, ties to the
    lower index."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def _take(table, idx):
    """table (B, M, C) rows by idx (B, ...) -> (B, ..., C)."""
    B = table.shape[0]
    batch = torch.arange(B, device=table.device).view(
        B, *([1] * (idx.dim() - 1)))
    return table[batch, idx]


def encoder(p, cfg: dict, pc, sn, node, train: bool, prec=FP32):
    """The SO-Net encoder.  Returns a dict with the global ``feature``
    (B, F) and the per-point and per-node maps the segmenter reads."""
    L = {name: spec for spec in layers(cfg) for name in [spec[0]]}
    B, N, _ = pc.shape
    M, k, K = node.shape[1], cfg["k"], cfg["som_k"]
    # each point joins its k nearest nodes; the k copies are stacked
    # k-major: copy i of every point, then copy i + 1
    near = nearest(sqdist(pc, node), k)                      # (B, N, k)
    seg = near.transpose(1, 2).reshape(B, k * N)             # (B, kN)
    x_stack = pc.repeat(1, k, 1)
    sn_stack = sn.repeat(1, k, 1)
    counts = torch.zeros(B, M, device=pc.device).scatter_add_(
        1, seg, torch.ones_like(seg, dtype=torch.float32))
    # the nodes move to the mean of their points
    sums = torch.zeros(B, M, 3, device=pc.device).scatter_add_(
        1, seg[..., None].expand(-1, -1, 3), x_stack)
    som_node = sums / (counts[..., None] + 1e-5)
    centers = _take(som_node, seg)
    x_dec = x_stack - centers
    fp = "encoder.first_pointnet.PointLayer_"
    h0 = point_layer(p, L[fp + "0"], torch.cat([x_dec, sn_stack], -1),
                     train, prec)
    h = point_layer(p, L[fp + "1"], h0, train, prec)
    h = point_layer(p, L[fp + "2"], h, train, prec)
    first = point_layer(p, L[fp + "3"], torch.cat([h0, h], -1), train, prec)
    # max over each node's points; an empty node takes stacked point 0
    C = first.shape[-1]
    pooled = torch.zeros(B, M, C, device=pc.device).scatter_reduce(
        1, seg[..., None].expand(-1, -1, C), first, reduce="amax",
        include_self=False)
    pooled = torch.where((counts == 0)[..., None], first[:, :1], pooled)
    # kNN over the input nodes; the module reads the moved ones
    knn_i = nearest(sqdist(node, node), K)                   # (B, M, K)
    coord = som_node.detach()
    nbrs = _take(coord, knn_i)                               # (B, M, K, 3)
    if cfg["som_k_type"] == "avg":
        center = nbrs.mean(2, keepdim=True)
    elif cfg["som_k_type"] == "center":
        center = coord[:, :, None, :]
    else:
        raise ValueError(cfg["som_k_type"])
    h = torch.cat([nbrs - center, _take(pooled, knn_i)], -1)
    h = point_layer(p, L["encoder.knnlayer.PointLayer_0"], h, train, prec)
    h = point_layer(p, L["encoder.knnlayer.PointLayer_1"], h, train, prec)
    knn_feature = h.amax(2)                                  # (B, M, 512)
    fin = torch.cat([center.squeeze(2), knn_feature], -1)
    h = point_layer(p, L["encoder.final_pointnet.PointLayer_0"], fin, train,
                    prec)
    final = point_layer(p, L["encoder.final_pointnet.PointLayer_1"], h,
                        train, prec)                          # (B, M, F)
    win = final.argmax(1, keepdim=True)                      # first winner
    feature = torch.gather(final, 1, win).squeeze(1)
    return dict(feature=feature, seg=seg, x_dec=x_dec, x_stack=x_stack,
                centers=centers, sn_stack=sn_stack, first=first,
                pooled=pooled, knn_feature=knn_feature, final=final)


def dropout(x, rate, generator, prec=FP32):
    """Keep each entry with probability 1 - rate (a mask drawn from
    ``generator``), scaled by 1 / (1 - rate)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - rate
    return prec.round(torch.where(keep, x / (1.0 - rate), 0.0))


def classify(p, cfg, batch, train, generator=None, prec=FP32):
    """Logits (B, classes) of the classifier."""
    L = {spec[0]: spec for spec in layers(cfg)}
    enc = encoder(p, cfg, batch["pc"], batch["sn"], batch["node"], train,
                  prec)
    drop = train and cfg["dropout"] > 0.1
    h = point_layer(p, L["classifier.fc1"], enc["feature"], train, prec)
    if drop:
        h = dropout(h, cfg["dropout"], generator, prec)
    h = point_layer(p, L["classifier.fc2"], h, train, prec)
    if drop:
        h = dropout(h, cfg["dropout"], generator, prec)
    return point_layer(p, L["classifier.fc3"], h, train, prec)


def segment(p, cfg, batch, train, generator=None, prec=FP32):
    """Per-point part scores (B, N, classes) of the segmenter."""
    L = {spec[0]: spec for spec in layers(cfg)}
    pc = batch["pc"]
    B, N, _ = pc.shape
    k = cfg["k"]
    enc = encoder(p, cfg, pc, batch["sn"], batch["node"], train, prec)
    seg = enc["seg"]
    kN = seg.shape[1]
    onehot = F.one_hot(batch["label"].long(), NUM_CATEGORIES).float()
    per_cloud = [onehot, enc["feature"]]
    parts = [enc["x_dec"], enc["x_stack"], enc["centers"], enc["sn_stack"],
             per_cloud[0][:, None].expand(B, kN, -1), enc["first"],
             _take(enc["pooled"], seg), _take(enc["knn_feature"], seg),
             _take(enc["final"], seg),
             per_cloud[1][:, None].expand(B, kN, -1)]
    h = point_layer(p, L["segmenter.layer1"], torch.cat(parts, -1), train,
                    prec)
    h = point_layer(p, L["segmenter.layer2"], h, train, prec)
    h = point_layer(p, L["segmenter.layer3"], h, train, prec)
    h = h.reshape(B, k, N, -1).mean(1)          # the k copies of a point
    h = point_layer(p, L["segmenter.layer4"], h, train, prec)
    if train and cfg["dropout"] > 0.1:
        h = dropout(h, cfg["dropout"], generator, prec)
    return point_layer(p, L["segmenter.layer5"], h, train, prec)


def forward(p, cfg, batch, train, generator=None, prec=FP32):
    """The task's output: logits (B, classes) or scores (B, N, classes)."""
    fn = classify if cfg["task"] == "classify" else segment
    return fn(p, cfg, batch, train, generator, prec)


def loss(cfg, out, batch, rows=None):
    """Mean softmax cross-entropy over the batch (over every point for the
    segmenter), or over the first ``rows`` items of it."""
    n = out.shape[0] if rows is None else rows
    if cfg["task"] == "classify":
        return F.cross_entropy(out[:n], batch["label"][:n].long())
    scores, target = out[:n], batch["seg"][:n].long()
    return F.cross_entropy(scores.reshape(-1, scores.shape[-1]),
                           target.reshape(-1))


def he_std(fan_in: int) -> float:
    return math.sqrt(2.0 / fan_in)
