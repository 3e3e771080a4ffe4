"""Where a lower-precision run rounds, and to what: the reference runs in
float32 (``Precision("float32")`` rounds nothing); the comparison's
control runs it one precision below the configuration's (bfloat16
activations -> 8-bit floats), rounding the same values the measured
program rounds to its compute dtype.

A rounded value keeps float32 storage.  The rounding applies to the
forward value and to the cotangent that flows back through it, as a
lower-precision forward and backward would.  8-bit floats are scaled per
tensor by their largest magnitude, as an fp8 recipe does: e4m3 (3
mantissa bits) forward, e5m2 (2 mantissa bits) backward.  8-bit integers
are symmetric, per tensor, scaled by the largest magnitude over 127.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


def _int8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(x / scale).clamp(-127, 127) * scale


def _round(x: torch.Tensor, name: str, backward: bool) -> torch.Tensor:
    if name == "bfloat16":
        return x.to(torch.bfloat16).float()
    if name == "int8":
        return _int8(x)
    if name == "float8":
        if backward:
            return _scaled(x, torch.float8_e5m2, _E5M2_MAX)
        return _scaled(x, torch.float8_e4m3fn, _E4M3_MAX)
    raise ValueError(f"precision {name!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return _round(x, name, backward=False)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.name, backward=True), None


class Precision:
    """``round(x)``: ``x`` as a run in this precision would hold it."""

    NAMES = ("float32", "bfloat16", "float8", "int8")

    def __init__(self, name: str):
        if name not in self.NAMES:
            raise ValueError(f"precision {name!r} (have {self.NAMES})")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        return _Round.apply(x, self.name)
