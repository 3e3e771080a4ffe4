"""Network modules of the port (counterparts of the JAX package's ``nn``),
channel-last."""

from .layers import (BatchNorm, ConcatDense, Conv3x3, Dense, InstanceNorm,
                     KNNModule, PointLayer, PointNetMLP, PointResNet, UpConv,
                     activation_fn)
from .encoder import (Encoder, EncoderOutput, Transformer, resolve_pooling,
                      rotation_matrix_y)
from .decoder import (ConvToPC, Decoder, DecoderConv, DecoderConvOutput,
                      DecoderLinear, DecoderOutput)
from .heads import ClassifierHead, SegmenterHead

__all__ = [
    "BatchNorm", "ConcatDense", "Dense", "KNNModule", "PointLayer",
    "PointNetMLP", "PointResNet", "activation_fn", "Conv3x3", "InstanceNorm",
    "UpConv", "ConvToPC", "Decoder", "DecoderConv", "DecoderConvOutput",
    "DecoderLinear", "DecoderOutput",
    "Encoder", "EncoderOutput", "Transformer", "resolve_pooling",
    "rotation_matrix_y", "ClassifierHead",
    "SegmenterHead",
]
