"""Plain SO-Net for 2-D clouds without normals (the MNIST classifier of
arXiv:1803.04249 §4) in float32 PyTorch: forward, loss, the batch drawn
from raw rows, and the first training steps by autograd and Adam,
written for the benchmark's comparison.

It follows ``model.py`` (the 3-D classifier) layer for layer, with D=2
and no normals: the first PointNet reads the decentered coordinates
alone (D -> 64), the kNN layer D + 384 -> 512 -> 512, the final PointNet
D + 512 -> 768 -> F, the head F -> 512 -> 256 -> classes.  Parameters are
a dict of tensors named as the measured package's ``state_dict`` names
them.  It borrows ``model.py``'s and ``train.py``'s helpers (the dense
layer with BatchNorm and ReLU, the distances, the nearest indices, the
dropout mask, the learning rate) and edits neither.  Nothing here imports
the measured program.

``sample`` reproduces the measured program's 2-D draws in their order:
subset keys only when the batch keeps fewer points than a raw row holds,
then point jitter (B, N, 2), node jitter (B, M, 2) and the per-cloud
scale; there is no normal jitter.

Departures from the reference code: ``model.py``'s (tie splitting in the
maxima, an empty node takes stacked point 0, nearest-node ties to the
lower index); besides, the SO-Net repository has no MNIST options file,
so the widths are the published encoder's, as ``model.py``'s, and the
input sizes the measured package's ``config.mnist()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .model import (FP32, Layer, _take, dropout, nearest, point_layer,
                    sqdist, trainable)
from .precision import Precision
from .train import ADAM_EPS, BETAS, learning_rate

D = 2


def _check(cfg: dict) -> None:
    if cfg["task"] != "classify":
        raise NotImplementedError(f"task {cfg['task']!r}: the classifier")
    if cfg["surface_normal"] or cfg["som_k"] < 2:
        raise NotImplementedError(
            "2-D clouds without normals, with the kNN layer (som_k >= 2)")
    if cfg["normalization"] != "batch" or cfg["activation"] != "relu":
        raise NotImplementedError("BatchNorm and ReLU only")
    for flag in ("rot_horizontal", "rot_perturbation",
                 "translation_perturbation"):
        if cfg.get(flag):
            raise NotImplementedError(f"{flag}: not in the reference")


def layers(cfg: dict) -> List[Layer]:
    """Every dense layer of the 2-D classifier, in order."""
    _check(cfg)
    F_ = cfg["feature_num"]
    fp = "encoder.first_pointnet.PointLayer_"
    return [(fp + "0", (D,), 64, True, True),
            (fp + "1", (64,), 128, True, True),
            (fp + "2", (128,), 256, True, True),
            (fp + "3", (64, 256), 384, False, True),
            ("encoder.knnlayer.PointLayer_0", (D + 384,), 512, True, True),
            ("encoder.knnlayer.PointLayer_1", (512,), 512, True, True),
            ("encoder.final_pointnet.PointLayer_0", (D + 512,), 768, True,
             True),
            ("encoder.final_pointnet.PointLayer_1", (768,), F_, False, True),
            ("classifier.fc1", (F_,), 512, True, True),
            ("classifier.fc2", (512,), 256, True, True),
            # the last classifier layer runs in float32 in every precision
            ("classifier.fc3", (256,), cfg["classes"], False, False)]


def param_specs(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{name: (shape, kind)} of every parameter and BatchNorm statistic,
    the kinds of ``model.param_specs``."""
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


def encoder(p, cfg: dict, pc, node, train: bool, prec=FP32):
    """The 2-D encoder: the global ``feature`` (B, F) and, for the tests,
    the decentered points ``x_dec`` (B, kN, 2) and the node ids ``seg``."""
    L = {spec[0]: spec for spec in layers(cfg)}
    B, N, _ = pc.shape
    M, k, K = node.shape[1], cfg["k"], cfg["som_k"]
    # each point joins its k nearest nodes, the copies stacked k-major
    near = nearest(sqdist(pc, node), k)                      # (B, N, k)
    seg = near.transpose(1, 2).reshape(B, k * N)             # (B, kN)
    x_stack = pc.repeat(1, k, 1)
    counts = torch.zeros(B, M, device=pc.device).scatter_add_(
        1, seg, torch.ones_like(seg, dtype=torch.float32))
    sums = torch.zeros(B, M, D, device=pc.device).scatter_add_(
        1, seg[..., None].expand(-1, -1, D), x_stack)
    som_node = sums / (counts[..., None] + 1e-5)
    x_dec = x_stack - _take(som_node, seg)
    fp = "encoder.first_pointnet.PointLayer_"
    # no normals: the first layer reads the decentered coordinates alone
    h0 = point_layer(p, L[fp + "0"], x_dec, train, prec)
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
    nbrs = _take(som_node.detach(), knn_i)                   # (B, M, K, 2)
    if cfg["som_k_type"] == "avg":
        center = nbrs.mean(2, keepdim=True)
    elif cfg["som_k_type"] == "center":
        center = som_node.detach()[:, :, None, :]
    else:
        raise ValueError(cfg["som_k_type"])
    h = torch.cat([nbrs - center, _take(pooled, knn_i)], -1)
    h = point_layer(p, L["encoder.knnlayer.PointLayer_0"], h, train, prec)
    h = point_layer(p, L["encoder.knnlayer.PointLayer_1"], h, train, prec)
    fin = torch.cat([center.squeeze(2), h.amax(2)], -1)
    h = point_layer(p, L["encoder.final_pointnet.PointLayer_0"], fin, train,
                    prec)
    final = point_layer(p, L["encoder.final_pointnet.PointLayer_1"], h,
                        train, prec)                          # (B, M, F)
    win = final.argmax(1, keepdim=True)                      # first winner
    return dict(feature=torch.gather(final, 1, win).squeeze(1), seg=seg,
                x_dec=x_dec)


def forward(p, cfg, batch, train, generator=None, prec=FP32):
    """Logits (B, classes) of the 2-D classifier."""
    L = {spec[0]: spec for spec in layers(cfg)}
    enc = encoder(p, cfg, batch["pc"], batch["node"], train, prec)
    drop = train and cfg["dropout"] > 0.1
    h = point_layer(p, L["classifier.fc1"], enc["feature"], train, prec)
    if drop:
        h = dropout(h, cfg["dropout"], generator, prec)
    h = point_layer(p, L["classifier.fc2"], h, train, prec)
    if drop:
        h = dropout(h, cfg["dropout"], generator, prec)
    return point_layer(p, L["classifier.fc3"], h, train, prec)


def loss(cfg, out, batch, rows=None):
    """Mean softmax cross-entropy over the batch, or over its first
    ``rows`` items."""
    n = out.shape[0] if rows is None else rows
    return F.cross_entropy(out[:n], batch["label"][:n].long())


def sample(raw: Dict[str, torch.Tensor], generator: torch.Generator,
           cfg: dict, train: bool) -> Dict[str, torch.Tensor]:
    """A batch from raw rows ``raw`` (pc (B, n_raw, 2), node (B, M, 2),
    label (B,)), drawn as the measured program draws a 2-D batch."""
    _check(cfg)
    pc, node = raw["pc"].float(), raw["node"].float()
    B, n_raw, _ = pc.shape
    N, M = min(cfg["input_pc_num"], n_raw), node.shape[1]
    kw = dict(generator=generator, device=pc.device)
    if N < n_raw:
        keys = torch.rand((B, n_raw), **kw)
        choice = torch.argsort(keys, dim=1, stable=True)[:, :N]
        pc = torch.gather(pc, 1, choice[..., None].expand(-1, -1, D))
    if train:
        jpc = torch.randn((B, N, D), **kw)
        jnode = torch.randn((B, M, D), **kw)
        scale = torch.rand((B, 1, 1), **kw) * 0.4 + 0.8
        pc = pc + torch.clamp(0.01 * jpc, -0.05, 0.05)
        node = node + torch.clamp(0.04 * jnode, -0.1, 0.1)
        pc, node = pc * scale, node * scale
    return {"pc": pc, "node": node, "label": raw["label"]}


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                raws: List[Dict[str, torch.Tensor]],
                generator: torch.Generator,
                steps_per_epoch: int, prec: Optional[Precision] = None,
                loss_rows: Optional[int] = None) -> dict:
    """``train.train_steps`` for the 2-D classifier: from ``weights`` (a
    fresh Adam), one batch per raw-row dict of ``raws``, the draws from
    ``generator`` in turn; ``loss_rows`` takes the loss over the first rows
    of each batch only (a planted fault).  Returns ``loss`` (one float a
    step), ``logits`` (each step's), ``grad`` (the first step's gradient
    by name) and ``change`` (each parameter after the last step minus its
    start)."""
    prec = prec or FP32
    names = trainable(param_specs(cfg))
    p = {n: t.detach().clone().float() for n, t in weights.items()}
    for n in names:
        p[n].requires_grad_(True)
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, logits, first = [], [], None
    for t, raw in enumerate(raws):
        batch = sample(raw, generator, cfg, train=True)
        out = forward(p, cfg, batch, True, generator, prec)
        value = loss(cfg, out, batch, loss_rows)
        grads = torch.autograd.grad(value, [p[n] for n in names])
        losses.append(float(value.detach()))
        logits.append(out.detach())
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr = learning_rate(cfg, t, steps_per_epoch)
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[n].sqrt() / bc2 ** 0.5 + ADAM_EPS
                p[n].addcdiv_(m[n], denom, value=-lr / bc1)
        del out, value, grads
    change = {n: (p[n].detach() - weights[n].float()) for n in names}
    return {"loss": losses, "logits": logits, "grad": first,
            "change": change}


def checked_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                  singles: List[dict], chain: List[dict], draw_seed: int,
                  steps_per_epoch: int, prec: Optional[Precision] = None,
                  loss_rows: Optional[int] = None) -> dict:
    """``train.checked_steps`` for the 2-D classifier: a first step from
    ``weights`` on each batch of ``singles``, then a run of ``len(chain)``
    steps from that start, every draw from one generator seeded with
    ``draw_seed`` on the rows' device, in that order; TF32 off on a card
    while it runs.  Returns ``first_losses``, ``first_logits`` (one a
    single), ``grad`` (the first single's), ``chain_losses`` and ``change``
    (after the chain)."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    kw = dict(prec=prec, loss_rows=loss_rows)
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    if dev.type == "cuda":
        for f in flags:
            f.allow_tf32 = False
    try:
        first_losses, first_logits, grad = [], [], None
        for raw in singles:
            one = train_steps(weights, cfg, [raw], gen, steps_per_epoch,
                              **kw)
            first_losses.append(one["loss"][0])
            first_logits.append(one["logits"][0])
            grad = grad if grad is not None else one["grad"]
        run = train_steps(weights, cfg, chain, gen, steps_per_epoch, **kw)
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b
    return {"first_losses": first_losses, "first_logits": first_logits,
            "grad": grad, "chain_losses": run["loss"],
            "change": run["change"]}
