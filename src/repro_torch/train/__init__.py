"""Training substrate: the AdamW optimizer and the step builders."""

from .optimizer import (AdamWConfig, TrainState,  # noqa: F401
                        adamw_init, adamw_update)
from .steps import build_train_step, train_batch_spec  # noqa: F401

__all__ = ["AdamWConfig", "TrainState", "adamw_init", "adamw_update",
           "build_train_step", "train_batch_spec"]
