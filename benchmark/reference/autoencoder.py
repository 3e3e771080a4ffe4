"""Plain SO-Net auto-encoder (arXiv:1803.04249 sections 3.4 and 4;
lijx10/SO-Net ``models/autoencoder.py``, ``models/networks.py``
``Decoder``, ``models/losses.py`` ``ChamferLoss``) in float32 PyTorch:
the decoder, the multi-scale Chamfer loss, their gradients by autograd,
Adam, and the checked steps the benchmark compares, written for the
benchmark's comparison.

Nothing here imports the measured program.  The encoder is
``model.encoder``; parameters are a dict of tensors named as the measured
package's ``state_dict`` names them, and ``param_specs`` lists them from
the configuration alone.  With TF32 off on a card (``true_float32``)
every product here is a float32 product.

The decoder, channel-last (a cloud is (B, P, 3), a feature map (B, H, W,
C)):

* FC branch: the global feature F -> 2P -> 3P -> 4P (dense, BatchNorm,
  ReLU) -> 3P (dense, float32), read as (3, P) and transposed to P points
  (P = ``output_fc_pc_num``);
* conv branch: the feature as a 1x1 map, six stages of nearest 2x
  upsampling, a 3x3 convolution with zero padding, BatchNorm and ReLU, to
  64x64, of widths F, F/2, F/4, F/8, F/8, F/8; taps (a dense, BatchNorm
  and ReLU layer of the same width, then a float32 dense layer to 3) at
  16x16 (``pc4``, 256 points), 32x32 (``pc5``, 1,024 points) and 64x64
  (``pc6``, 4,096 points);
* the output cloud is the FC branch's points followed by the conv level
  that ``output_conv_pc_num`` names (``pc5`` in the benchmark's
  configuration, ``pc6`` at 4,096).

The loss is the bidirectional 1-NN Chamfer distance of the output cloud
to the input cloud plus those of the lower taps (``pc4`` at 1,024 conv
points; ``pc4`` and ``pc5`` at 4,096), each the mean over the predicted
points of the distance to the nearest input point plus the mean over the
input points of the distance to the nearest predicted point, a distance
being sqrt(sum_sq + 1e-8).

Departures from the reference code, none a change to the mathematics of a
step:

* the nearest points come from an exact ``argmin`` over sums of squared
  differences, computed apart from the measured program's
  |a|^2 + |b|^2 - 2 a.b, in place of Faiss' flat L2 index.  A near-tie
  (two distances within the float32 rounding of the larger form, about
  2e-7 for clouds in the unit ball) can then pick another point on the
  two sides; the picked distance then differs by that rounding, which
  moves a loss of about 0.1-1 by under 1e-6 of itself per flip, and moves
  the picked point's gradient to its near-twin;
* the first (lowest) index wins a tie, and ties are searched over the
  whole batch at once instead of one item at a time;
* layout: channel-last feature maps; a convolution kernel is (out, in, 3,
  3), as the measured package stores it;
* at 1,024 conv points the 64x64 stage (``UpConv_5``, ``ConvToPC_2``),
  which nothing reads, runs in training without a graph, for its BatchNorm
  statistics only, and its parameters get no gradient: the reference code
  computes it in the graph and its gradient is zero;
* BatchNorm normalises with the biased variance in two passes (the
  running statistics are not compared).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import model
from .precision import Precision
from .train import ADAM_EPS, BETAS, learning_rate, sample

FP32 = model.FP32
ROBUST_EPS = 1e-8
FC = "decoder.fc_decoder."
CONV = "decoder.conv_decoder."


def _check(cfg: dict) -> None:
    if cfg["task"] != "autoencode":
        raise NotImplementedError(f"task {cfg['task']!r}")
    if cfg["output_conv_pc_num"] not in (1024, 4096) \
            or cfg["output_fc_pc_num"] <= 0:
        raise NotImplementedError(
            "the FC branch and 1,024 or 4,096 conv points only")
    if cfg["normalization"] != "batch" or cfg["activation"] != "relu":
        raise NotImplementedError("BatchNorm and ReLU only")


def encoder_cfg(cfg: dict) -> dict:
    """The configuration ``model.encoder`` reads: the encoder's layers do
    not depend on the head, so any task it knows names them."""
    return {**cfg, "task": "classify"}


def conv_widths(cfg: dict) -> List[int]:
    F_ = cfg["feature_num"]
    return [F_, F_ // 2, F_ // 4, F_ // 8, F_ // 8, F_ // 8]


def _bn_specs(name: str, width: int) -> dict:
    b = name + ".BatchNorm_0."
    return {b + "weight": ((width,), "bn_weight"),
            b + "bias": ((width,), "bn_bias"),
            b + "running_mean": ((width,), "running_mean"),
            b + "running_var": ((width,), "running_var")}


def param_specs(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{name: (shape, kind)} of every parameter and BatchNorm statistic.
    Kinds as ``model.param_specs``' plus ``conv_weight`` (out, in, 3, 3)
    and ``point_bias`` (the bias of a float32 layer that emits points).
    A convolution's bias, added before its BatchNorm, is a ``bias``."""
    _check(cfg)
    specs = {n: s for n, s in model.param_specs(encoder_cfg(cfg)).items()
             if n.startswith("encoder.")}
    P, cin = cfg["output_fc_pc_num"], cfg["feature_num"]
    for i, c in enumerate((2 * P, 3 * P, 4 * P)):
        name = f"{FC}PointLayer_{i}"
        specs[name + ".Dense_0.weight"] = ((c, cin), "weight")
        specs[name + ".Dense_0.bias"] = ((c,), "bias")
        specs.update(_bn_specs(name, c))
        cin = c
    specs[FC + "linear_out.weight"] = ((3 * P, cin), "weight")
    specs[FC + "linear_out.bias"] = ((3 * P,), "point_bias")
    cin = cfg["feature_num"]
    for i, c in enumerate(conv_widths(cfg)):
        name = f"{CONV}UpConv_{i}"
        specs[name + ".Conv_0.weight"] = ((c, cin, 3, 3), "conv_weight")
        specs[name + ".Conv_0.bias"] = ((c,), "bias")
        specs.update(_bn_specs(name, c))
        cin = c
    for i in range(3):
        name = f"{CONV}ConvToPC_{i}"
        specs[name + ".PointLayer_0.Dense_0.weight"] = ((cin, cin), "weight")
        specs[name + ".PointLayer_0.Dense_0.bias"] = ((cin,), "bias")
        specs.update(_bn_specs(name + ".PointLayer_0", cin))
        specs[name + ".Dense_0.weight"] = ((3, cin), "weight")
        specs[name + ".Dense_0.bias"] = ((3,), "point_bias")
    return specs


def unread(cfg: dict, name: str) -> bool:
    """Whether a parameter belongs to the 64x64 stage where no output reads
    it (at 1,024 conv points)."""
    return cfg["output_conv_pc_num"] == 1024 and name.startswith(
        (CONV + "UpConv_5.", CONV + "ConvToPC_2."))


# ---------------------------------------------------------------------------
# the decoder

def _batchnorm(p, name, x, train, stats):
    """BatchNorm over every axis but the last; in training with the batch
    statistics, each recorded in ``stats`` (name: (mean, biased var,
    rows)) when it is a dict."""
    b = name + ".BatchNorm_0."
    if train:
        rows = tuple(range(x.dim() - 1))
        mean = x.mean(rows)
        var = (x - mean).square().mean(rows)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach(),
                           x.numel() // x.shape[-1])
    else:
        mean, var = p[b + "running_mean"], p[b + "running_var"]
    return (x - mean) / torch.sqrt(var + model.BN_EPS) * p[b + "weight"] \
        + p[b + "bias"]


def _bn_relu(p, name, y, train, stats, q):
    return q(F.relu(q(_batchnorm(p, name, y, train, stats))))


def _dense(p, name, x, q):
    return q(q(x) @ q(p[name + ".weight"]).t() + q(p[name + ".bias"]))


def point_layer(p, name, x, train, stats, q):
    """dense -> BatchNorm -> ReLU over the last axis, rounded by ``q``
    where a lower-precision run rounds."""
    return _bn_relu(p, name, _dense(p, name + ".Dense_0", x, q), train,
                    stats, q)


def up_conv(p, name, x, train, stats, q):
    """(B, H, W, C) -> nearest 2x -> 3x3 convolution (zero padding) ->
    BatchNorm -> ReLU: (B, 2H, 2W, out)."""
    x = q(x).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    w, b = p[name + ".Conv_0.weight"], p[name + ".Conv_0.bias"]
    y = F.conv2d(x.permute(0, 3, 1, 2), q(w), padding=1).permute(0, 2, 3, 1)
    return _bn_relu(p, name, q(y + q(b)), train, stats, q)


def conv_to_pc(p, name, x, train, stats, q):
    """(B, H, W, C) -> (B, H W, 3): a point layer, then a float32 dense
    layer to 3 coordinates."""
    h = point_layer(p, name + ".PointLayer_0", x, train, stats, q)
    pts = h @ p[name + ".Dense_0.weight"].t() + p[name + ".Dense_0.bias"]
    return pts.reshape(x.shape[0], -1, 3)


def decoder(p, cfg: dict, feature, train: bool, prec: Precision = FP32,
            stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The decoder's outputs from the global feature (B, F): ``pc`` (B,
    P + conv points, 3), ``linear_pc`` (B, P, 3), ``pc4`` (B, 256, 3),
    ``pc5`` (B, 1024, 3) and, at 4,096 conv points, ``pc6`` (B, 4096, 3).
    At 1,024 the 64x64 stage runs in training only, without a graph.
    Each BatchNorm's batch statistics are recorded in ``stats``."""
    _check(cfg)
    q = prec.round
    B, P = feature.shape[0], cfg["output_fc_pc_num"]
    h = feature
    for i in range(3):
        h = point_layer(p, f"{FC}PointLayer_{i}", h, train, stats, q)
    h = h @ p[FC + "linear_out.weight"].t() + p[FC + "linear_out.bias"]
    linear_pc = h.reshape(B, 3, P).transpose(1, 2)
    x = feature.reshape(B, 1, 1, -1)
    for i in range(4):
        x = up_conv(p, f"{CONV}UpConv_{i}", x, train, stats, q)   # 16x16
    pc4 = conv_to_pc(p, CONV + "ConvToPC_0", x, train, stats, q)
    x = up_conv(p, CONV + "UpConv_4", x, train, stats, q)         # 32x32
    pc5 = conv_to_pc(p, CONV + "ConvToPC_1", x, train, stats, q)
    out = {"linear_pc": linear_pc, "pc4": pc4, "pc5": pc5}

    def stage6():
        return conv_to_pc(p, CONV + "ConvToPC_2",
                          up_conv(p, CONV + "UpConv_5", x, train, stats, q),
                          train, stats, q)                          # 64x64
    if cfg["output_conv_pc_num"] == 4096:
        out["pc6"] = stage6()
    elif train:
        with torch.no_grad():      # for its BatchNorm statistics only
            stage6()
    last = out["pc6"] if "pc6" in out else pc5
    return {"pc": torch.cat([linear_pc, last], 1), **out}


def forward(p, cfg: dict, batch, train: bool, generator=None,
            prec: Precision = FP32, stats: Optional[dict] = None):
    """The encoder, then the decoder (``decoder``).  The model draws no
    random numbers: ``generator`` is not read."""
    enc = model.encoder(p, encoder_cfg(cfg), batch["pc"], batch["sn"],
                        batch["node"], train, prec)
    return decoder(p, cfg, enc["feature"], train, prec, stats)


# ---------------------------------------------------------------------------
# the loss

def _take(pc, idx):
    """pc (B, N, 3) rows by idx (B, P) -> (B, P, 3)."""
    return torch.gather(pc, 1, idx[..., None].expand(-1, -1, pc.shape[-1]))


def _robust(diff):
    return torch.sqrt(diff.square().sum(-1) + ROBUST_EPS)


def chamfer(pred, gt) -> torch.Tensor:
    """Per item (B,): the bidirectional 1-NN Chamfer distance of ``pred``
    (B, P, 3) and ``gt`` (B, N, 3).  The matches carry no gradient; the
    gradient flows through the matched pairs' distances."""
    with torch.no_grad():
        d = (pred[:, :, None, :] - gt[:, None, :, :]).square().sum(-1)
        to_gt, to_pred = d.argmin(2), d.argmin(1)    # (B, P), (B, N)
        del d
    forward_ = _robust(_take(gt, to_gt) - pred).mean(1)
    backward_ = _robust(_take(pred, to_pred) - gt).mean(1)
    return forward_ + backward_


def loss(cfg: dict, out: dict, batch, rows: Optional[int] = None):
    """The multi-scale Chamfer loss: the output cloud's and the lower taps'
    distances to the input cloud, the mean over the batch (over its first
    ``rows`` items only, a planted fault)."""
    gt = batch["pc"]
    taps = ("pc4",) if cfg["output_conv_pc_num"] == 1024 else ("pc4", "pc5")
    per_item = chamfer(out["pc"], gt)
    for tap in taps:
        per_item = per_item + chamfer(out[tap], gt)
    return per_item[:rows].mean() if rows is not None else per_item.mean()


# ---------------------------------------------------------------------------
# training

@contextlib.contextmanager
def true_float32(device):
    """Float32 products and convolutions on a card in float32, not TF32;
    the flags as they were afterwards."""
    if torch.device(device).type != "cuda":
        yield
        return
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                raws: List[Dict[str, torch.Tensor]], generator: torch.Generator,
                steps_per_epoch: int, prec: Optional[Precision] = None,
                loss_rows: Optional[int] = None) -> dict:
    """Train from ``weights`` (a fresh Adam) on one batch per raw-row dict
    of ``raws``, the draws (``train.sample``) taken from ``generator`` in
    turn; as ``train.train_steps``.  A parameter without a gradient (the
    unread 64x64 stage's) keeps its value, as Adam leaves a parameter that
    has none.  ``clouds``: the first step's output cloud, ``pc4`` tap and
    input cloud (the loss's target)."""
    prec = prec or FP32
    names = model.trainable(param_specs(cfg))
    p = {n: t.detach().clone().float() for n, t in weights.items()}
    live = [n for n in names if not unread(cfg, n)]
    for n in live:
        p[n].requires_grad_(True)
    m = {n: torch.zeros_like(p[n]) for n in live}
    v = {n: torch.zeros_like(p[n]) for n in live}
    losses, first, clouds = [], None, None
    for t, raw in enumerate(raws):
        batch = sample(raw, generator, cfg, train=True)
        out = forward(p, cfg, batch, True, generator, prec)
        value = loss(cfg, out, batch, loss_rows)
        grads = dict(zip(live, torch.autograd.grad(value,
                                                   [p[n] for n in live])))
        losses.append(float(value.detach()))
        if first is None:
            first = {n: (grads[n].detach().clone() if n in grads
                         else torch.zeros_like(p[n])) for n in names}
            clouds = {"pc": out["pc"].detach(), "pc4": out["pc4"].detach(),
                      "target": batch["pc"].detach()}
        lr = learning_rate(cfg, t, steps_per_epoch)
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
        with torch.no_grad():
            for n, g in grads.items():
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[n].sqrt() / bc2 ** 0.5 + ADAM_EPS
                p[n].addcdiv_(m[n], denom, value=-lr / bc1)
        del out, value, grads
    change = {n: (p[n].detach() - weights[n].float()) for n in names}
    return {"loss": losses, "grad": first, "change": change,
            "clouds": clouds}


def checked_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                  singles: List[dict], chain: List[dict], draw_seed: int,
                  steps_per_epoch: int, prec: Optional[Precision] = None,
                  loss_rows: Optional[int] = None) -> dict:
    """What the benchmark checks of a training run, as
    ``train.checked_steps``: a first step from ``weights`` on each batch
    of ``singles``, then a run of ``len(chain)`` steps from that start,
    every draw from one generator seeded with ``draw_seed``; TF32 off.
    ``first_clouds``: each first step's ``clouds`` (``train_steps``)."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    kw = dict(prec=prec, loss_rows=loss_rows)
    first_losses, first_clouds, grad = [], [], None
    with true_float32(dev):
        for raw in singles:
            one = train_steps(weights, cfg, [raw], gen, steps_per_epoch, **kw)
            first_losses.append(one["loss"][0])
            first_clouds.append(one["clouds"])
            grad = grad if grad is not None else one["grad"]
        run = train_steps(weights, cfg, chain, gen, steps_per_epoch, **kw)
    return {"first_losses": first_losses, "first_clouds": first_clouds,
            "grad": grad, "chain_losses": run["loss"],
            "change": run["change"]}
