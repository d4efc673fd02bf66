"""Training: the masked AdamW, schedules and phase machine
(``optimizer.py``) and the train step (``step.py``)."""

from .optimizer import (AdamState, Phase, adam_init, adam_update, clip_gradients,
                        group_trainable, label_params, masks_and_lrs, phase_for_epoch)
from .step import (AugmentDraws, Scalars, StepStatics, TrainState, augment_views,
                   init_train_state, make_train_step, reinit_optimizer, sample_augment)

__all__ = ["AdamState", "Phase", "adam_init", "adam_update", "clip_gradients",
           "group_trainable", "label_params", "masks_and_lrs", "phase_for_epoch",
           "AugmentDraws", "Scalars", "StepStatics", "TrainState", "augment_views",
           "init_train_state", "make_train_step", "reinit_optimizer", "sample_augment"]
