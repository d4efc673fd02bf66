"""Training: the masked AdamW, schedules and phase machine
(``optimizer.py``) and the train step (``step.py``)."""

from .optimizer import (AdamState, Phase, adam_init, adam_update, clip_gradients,
                        group_trainable, label_params, masks_and_lrs, phase_for_epoch)
from .step import (Scalars, StepStatics, TrainState, init_train_state, make_train_step,
                   reinit_optimizer)

__all__ = ["AdamState", "Phase", "adam_init", "adam_update", "clip_gradients",
           "group_trainable", "label_params", "masks_and_lrs", "phase_for_epoch",
           "Scalars", "StepStatics", "TrainState", "init_train_state", "make_train_step",
           "reinit_optimizer"]
