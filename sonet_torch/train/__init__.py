"""Training (port of the JAX package's ``train``): losses, the train
state with per-subnetwork Adam and the halving schedule, and the
classify train and eval steps.  The ``Trainer``, data loaders and
checkpoints arrive with later slices."""

from . import losses
from .loops import make_classify_steps, random_point_dropout
from .state import TrainState, halving_schedule, init_state, make_optimizer

__all__ = [
    "losses", "TrainState", "init_state", "make_optimizer",
    "halving_schedule", "make_classify_steps", "random_point_dropout",
]
