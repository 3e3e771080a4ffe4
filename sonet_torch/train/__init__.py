"""Training (port of the JAX package's ``train``): losses, the train
state with per-subnetwork Adam and the halving schedule, the classify,
segment and autoencode train and eval steps, checkpoints, steps captured
as CUDA graphs and replayed over an epoch (``graphs``), and the
epoch-loop ``Trainer`` over a dataset."""

from . import losses
from .checkpoints import (latest_checkpoint, restore_checkpoint,
                          restore_encoder, save_checkpoint)
from .loops import (make_autoencode_steps, make_classify_steps,
                    make_segment_steps, make_steps, random_point_dropout)
from .state import TrainState, halving_schedule, init_state, make_optimizer
from .trainer import Trainer, build_dataset

__all__ = [
    "losses", "TrainState", "init_state", "make_optimizer",
    "halving_schedule", "make_classify_steps", "make_segment_steps",
    "make_autoencode_steps", "make_steps", "random_point_dropout", "save_checkpoint",
    "latest_checkpoint", "restore_checkpoint", "restore_encoder",
    "Trainer", "build_dataset",
]
