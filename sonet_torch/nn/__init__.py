"""Network modules of the port (counterparts of the JAX package's ``nn``),
channel-last."""

from .layers import (BatchNorm, ConcatDense, Dense, KNNModule, PointLayer,
                     PointNetMLP, PointResNet, activation_fn)
from .encoder import Encoder, EncoderOutput, resolve_pooling
from .heads import ClassifierHead, SegmenterHead

__all__ = [
    "BatchNorm", "ConcatDense", "Dense", "KNNModule", "PointLayer",
    "PointNetMLP", "PointResNet", "activation_fn",
    "Encoder", "EncoderOutput", "resolve_pooling", "ClassifierHead",
    "SegmenterHead",
]
