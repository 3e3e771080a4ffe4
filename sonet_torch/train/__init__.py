"""Training (port of the JAX package's ``train``): losses, the train
state with per-subnetwork Adam and the halving schedule, the classify and
segment train and eval steps, and checkpoints.  The ``Trainer`` and the
data loaders arrive with later slices."""

from . import losses
from .checkpoints import (latest_checkpoint, restore_checkpoint,
                          restore_encoder, save_checkpoint)
from .loops import (make_classify_steps, make_segment_steps, make_steps,
                    random_point_dropout)
from .state import TrainState, halving_schedule, init_state, make_optimizer

__all__ = [
    "losses", "TrainState", "init_state", "make_optimizer",
    "halving_schedule", "make_classify_steps", "make_segment_steps",
    "make_steps", "random_point_dropout", "save_checkpoint",
    "latest_checkpoint", "restore_checkpoint", "restore_encoder",
]
