"""Training loop, checkpoints, fault tolerance (port of ``repro/train``)."""
from repro_torch.train.train_step import (  # noqa: F401
    TrainState, cross_entropy, init_train_state, loss_fn, make_train_step,
    train_step,
)
from repro_torch.train.trainer import FailureInjector, TrainConfig, Trainer  # noqa: F401
from repro_torch.train import checkpoint  # noqa: F401
