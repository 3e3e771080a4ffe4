"""The autoencoder's point decoder (port of the JAX package's
``nn/decoder.py``).

Two branches from the global feature:

* ``DecoderLinear``: an FC pyramid F -> 2P -> 3P -> 4P -> 3P read as P
  points; the last bias starts at U(-1, 1), spread over the unit cube.
* ``DecoderConv``: six ``UpConv`` stages that grow a 1x1 feature map to
  64x64 (NHWC), with ``ConvToPC`` taps at 16x16 (``pc4``, 256 points),
  32x32 (``pc5``, 1024) and 64x64 (``pc6``, 4096).

``Decoder`` joins the FC branch with the conv level that
``output_conv_pc_num`` selects.

The 64x64 stage (``UpConv_5`` and ``ConvToPC_2``) is read only when
``output_conv_pc_num`` is 4096.  Its parameters always exist, so the two
packages' variables map one to one.  Where nothing reads it, the eval
forward skips it (``conv_pc6`` is None) and the train forward runs it
without a graph, only to keep its BatchNorm running statistics equal to
the JAX package's, which computes them in every train step; its
parameters then get no gradient and never move, as in the JAX package,
where their gradient is zero.

``Decoder.forward`` is the profiler range ``sonet:decoder``
(``utils/spans.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import Config
from ..utils.spans import span
from .encoder import layer_kw
from .layers import Dense, PointLayer, UpConv

SPAN = "sonet:decoder"


def _dense_out(in_features: int, features: int,
               generator: torch.Generator) -> Dense:
    """A float32 dense layer whose bias starts at U(-1, 1)."""
    dense = Dense(in_features, features, generator)
    with torch.no_grad():
        dense.bias.copy_(torch.rand(features, generator=generator) * 2.0 - 1.0)
    return dense


def _layer_options(cfg: Config) -> dict:
    return dict(activation=cfg.activation, normalization=cfg.normalization,
                **layer_kw(cfg))


class DecoderLinear(nn.Module):
    """feature (B, F) -> (B, P, 3), P = ``cfg.output_fc_pc_num``."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.P = P = cfg.output_fc_pc_num
        kw = _layer_options(cfg)
        cin = cfg.feature_num
        for i, c in enumerate((2 * P, 3 * P, 4 * P)):
            self.add_module(f"PointLayer_{i}", PointLayer(cin, c, generator,
                                                          **kw))
            cin = c
        self.linear_out = _dense_out(cin, 3 * P, generator)

    def forward(self, feature: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        h = feature
        for i in range(3):
            h = getattr(self, f"PointLayer_{i}")(h, epoch=epoch)
        h = self.linear_out(h.float())
        # the 3P vector is (3, P) channel-first; points are channel-last
        return h.reshape(-1, 3, self.P).transpose(1, 2)          # (B, P, 3)


class ConvToPC(nn.Module):
    """A shared layer with activation and normalization, then a float32
    dense layer to 3 channels whose bias starts at U(-1, 1):
    (B, H, W, C) -> (B, H, W, 3)."""

    def __init__(self, cfg: Config, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.PointLayer_0 = PointLayer(features, features, generator,
                                       **_layer_options(cfg))
        self.Dense_0 = _dense_out(features, 3, generator)

    def forward(self, x: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        return self.Dense_0(self.PointLayer_0(x, epoch=epoch).float())


class DecoderConvOutput(NamedTuple):
    pc4: torch.Tensor              # (B, 256, 3)
    pc5: torch.Tensor              # (B, 1024, 3)
    pc6: Optional[torch.Tensor]    # (B, 4096, 3), or None where not read


class DecoderConv(nn.Module):
    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        F = cfg.feature_num
        kw = _layer_options(cfg)
        widths = (F, F // 2, F // 4, F // 8, F // 8, F // 8)
        cin = F
        for i, c in enumerate(widths):
            self.add_module(f"UpConv_{i}", UpConv(cin, c, generator, **kw))
            cin = c
        for i in range(3):
            self.add_module(f"ConvToPC_{i}", ConvToPC(cfg, F // 8, generator))

    def forward(self, feature: torch.Tensor, epoch: Optional[int] = None,
                read_pc6: bool = True) -> DecoderConvOutput:
        """``read_pc6``: whether the caller reads the 64x64 level (see the
        module doc for what happens to it otherwise)."""
        B = feature.shape[0]

        def tap(i, x):
            return getattr(self, f"ConvToPC_{i}")(x, epoch).reshape(B, -1, 3)

        x = feature.reshape(B, 1, 1, -1)                         # NHWC 1x1
        for i in range(4):
            x = getattr(self, f"UpConv_{i}")(x, epoch)           # 16x16
        pc4 = tap(0, x)
        x = self.UpConv_4(x, epoch)                              # 32x32
        pc5 = tap(1, x)
        pc6 = None
        if read_pc6:
            pc6 = tap(2, self.UpConv_5(x, epoch))                # 64x64
        elif self.training:
            with torch.no_grad():       # for its running statistics only
                tap(2, self.UpConv_5(x, epoch))
        return DecoderConvOutput(pc4=pc4, pc5=pc5, pc6=pc6)


class DecoderOutput(NamedTuple):
    pc: torch.Tensor                     # (B, output_pc_num, 3) final cloud
    linear_pc: Optional[torch.Tensor]    # (B, output_fc_pc_num, 3)
    conv_pc4: Optional[torch.Tensor]     # (B, 256, 3)
    conv_pc5: Optional[torch.Tensor]     # (B, 1024, 3)
    conv_pc6: Optional[torch.Tensor]     # (B, 4096, 3)


class Decoder(nn.Module):
    """feature (B, F) -> ``DecoderOutput``.  Raises ``ValueError`` when
    ``cfg.output_pc_num`` is set and is not the FC branch's points plus
    the selected conv level's."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.conv_pc_num = cfg.output_conv_pc_num
        conv_out_num = (cfg.output_conv_pc_num
                        if cfg.output_conv_pc_num in (1024, 4096) else 0)
        derived = cfg.output_fc_pc_num + conv_out_num
        if cfg.output_pc_num > 0 and cfg.output_pc_num != derived:
            raise ValueError(
                f"output_pc_num={cfg.output_pc_num} inconsistent with "
                f"output_fc_pc_num={cfg.output_fc_pc_num} + selected "
                f"conv output {conv_out_num} (= {derived})")
        self.fc_decoder = (DecoderLinear(cfg, generator)
                           if cfg.output_fc_pc_num > 0 else None)
        self.conv_decoder = (DecoderConv(cfg, generator)
                             if cfg.output_conv_pc_num > 0 else None)

    def forward(self, feature: torch.Tensor,
                epoch: Optional[int] = None) -> DecoderOutput:
        with span(SPAN):
            return self._forward(feature, epoch)

    def _forward(self, feature, epoch):
        linear_pc = conv = conv_out = None
        if self.fc_decoder is not None:
            linear_pc = self.fc_decoder(feature, epoch)
        if self.conv_decoder is not None:
            conv = self.conv_decoder(feature, epoch,
                                     read_pc6=self.conv_pc_num == 4096)
            if self.conv_pc_num == 4096:
                conv_out = conv.pc6
            elif self.conv_pc_num == 1024:
                conv_out = conv.pc5
        if linear_pc is None:
            pc = conv_out
        elif conv_out is None:
            pc = linear_pc
        else:
            pc = torch.cat([linear_pc, conv_out], 1)
        return DecoderOutput(pc=pc, linear_pc=linear_pc,
                             conv_pc4=conv.pc4 if conv is not None else None,
                             conv_pc5=conv.pc5 if conv is not None else None,
                             conv_pc6=conv.pc6 if conv is not None else None)
