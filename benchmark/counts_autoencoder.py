"""Operations of the auto-encoder's train step, counted from its
configuration's shapes (``counts.py`` counts the classifier and the
segmenter; this adds the decoder and the Chamfer loss).

* the encoder: ``counts.forward_flops``' terms without the classifier's
  head;
* the decoder, read: the FC branch F -> 2P -> 3P -> 4P -> 3P over the B
  clouds; the 3x3 convolutions of the first five stages at their output
  sizes 2x2 ... 32x32 (2 x 9 c_in c_out a pixel); the 16x16 and 32x32
  taps, a dense c -> c and c -> 3 over their pixels;
* the decoder, unread: the 64x64 stage (its convolution and its tap),
  which a train step runs forward only, for its BatchNorm statistics;
* the Chamfer loss: the (B, P, N) distances of its two calls, geometry.
"""

from __future__ import annotations

from typing import Dict

from benchmark import counts

_dense = counts._dense


def _conv3x3(batch: int, side: int, cin: int, cout: int) -> float:
    return 2.0 * batch * side * side * 9 * cin * cout


def _tap(batch: int, side: int, c: int) -> float:
    return _dense(batch * side * side, c, c) + _dense(batch * side * side, c, 3)


def forward_flops(cfg: dict, batch: int) -> Dict[str, float]:
    """The products of one train forward of ``batch`` clouds, by part:
    ``weights`` (the encoder's and the read decoder's products with
    learned weights), ``unread`` (the 64x64 stage) and ``geometry`` (the
    encoder's distances and cluster sums, the Chamfer distances)."""
    if cfg["output_conv_pc_num"] != 1024:
        raise NotImplementedError("counted for 1,024 conv points (pc5)")
    B, F_, P = batch, cfg["feature_num"], cfg["output_fc_pc_num"]
    enc = counts.forward_flops({**cfg, "task": "classify"}, B)
    head = (_dense(B, F_, 512) + _dense(B, 512, 256)
            + _dense(B, 256, cfg["classes"]))
    fc = (_dense(B, F_, 2 * P) + _dense(B, 2 * P, 3 * P)
          + _dense(B, 3 * P, 4 * P) + _dense(B, 4 * P, 3 * P))
    widths = [F_, F_ // 2, F_ // 4, F_ // 8, F_ // 8, F_ // 8]
    conv, cin = [], F_
    for i, c in enumerate(widths):
        conv.append(_conv3x3(B, 2 ** (i + 1), cin, c))
        cin = c
    read = fc + sum(conv[:5]) + _tap(B, 16, cin) + _tap(B, 32, cin)
    unread = conv[5] + _tap(B, 64, cin)
    N = cfg["input_pc_num"]
    chamfer = 2.0 * B * (P + 1024) * N * 3 + 2.0 * B * 256 * N * 3
    return {"weights": enc["weights"] - head + read, "unread": unread,
            "geometry": enc["geometry"] + chamfer}


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one train step: three times the products with learned
    weights that the loss reads (forward, and the backward's two
    products), once the unread stage and the geometry."""
    f = forward_flops(cfg, cfg["batch_size"])
    return 3.0 * f["weights"] + f["unread"] + f["geometry"]
