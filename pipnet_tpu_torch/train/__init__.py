"""Training: the masked AdamW, schedules and phase machine
(``optimizer.py``), the train and eval steps (``step.py``), checkpoints
(``checkpoint.py``) and the ``Trainer`` (``trainer.py``)."""

from .checkpoint import (checkpoint_meta, latest_train_checkpoint, load_backbone_only,
                         resolve_checkpoint, restore_checkpoint, save_checkpoint)
from .optimizer import (AdamState, Phase, adam_init, adam_update, clip_gradients,
                        group_trainable, label_params, masks_and_lrs, phase_for_epoch)
from .step import (AugmentDraws, Scalars, StepStatics, TrainState, augment_views,
                   init_train_state, make_eval_step, make_train_step, reinit_optimizer,
                   sample_augment)
from .trainer import Trainer

__all__ = ["AdamState", "Phase", "adam_init", "adam_update", "clip_gradients",
           "group_trainable", "label_params", "masks_and_lrs", "phase_for_epoch",
           "AugmentDraws", "Scalars", "StepStatics", "TrainState", "augment_views",
           "init_train_state", "make_eval_step", "make_train_step", "reinit_optimizer",
           "sample_augment", "Trainer", "checkpoint_meta", "latest_train_checkpoint",
           "load_backbone_only", "resolve_checkpoint", "restore_checkpoint",
           "save_checkpoint"]
