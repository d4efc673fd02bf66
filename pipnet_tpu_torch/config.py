"""Static model/training configuration: frozen dataclasses.

The port's own copy of the JAX package's configuration records, field for
field, so that ``run_io`` reads and writes the same ``metadata/config.json``.
Only the serving slice reads them today; the training fields are kept so a
run directory written by either package round-trips unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class HeadConfig:
    """Prototype-head semantics (ref pipnet/pipnet.py:111-171)."""
    add_on_type: str = "conv"            # conv | unit | project | l2
    add_on_bias: bool = False
    softmax_tau: Optional[float] = 1.0   # None disables the per-node softmax; '--softmax y|1'
    gumbel_softmax: bool = False
    gumbel_tau: float = 0.5              # --gs_tau
    softmax_over_channel: bool = False
    multiply_cs_softmax: bool = False
    focal: bool = False                  # pooled = maxpool - avgpool
    classifier: str = "nonneg"           # nonneg | linear
    classifier_bias: bool = False        # --bias
    protopool: bool = True               # 'y': prototypes shared across children
    sg_before_protos: bool = False
    inference_threshold: float = 0.1     # pooled < 0.1 -> 0 at inference


@dataclass(frozen=True)
class ModelConfig:
    backbone: str = "convnext_tiny_26"
    image_size: int = 224
    num_features: int = 0                # flat-tree prototype count override
    num_protos_per_descendant: int = 0
    num_protos_per_child: int = 10
    head: HeadConfig = field(default_factory=HeadConfig)
    pretrained_backbone_path: Optional[str] = None
    compute_dtype: str = "float32"       # float32 | bfloat16
    use_pallas_head: bool = False
    use_pallas_backbone: bool = False    # fused ConvNeXt block kernel
    use_byol: bool = False               # add patch-level BYOL projector/predictor
    fast_gelu: bool = False              # tanh-approx GELU (perf mode; exact erf = parity)
    stage4_reducer: Tuple[Tuple[int, int, bool], ...] = ()   # (in, out, gelu) stack
    # '--basic_cnext_gaussian_multiplier stages|sigma|factor'
    gaussian_stages: Tuple[int, ...] = ()
    gaussian_sigma: float = 1.0
    gaussian_factor: float = 50.0


@dataclass(frozen=True)
class LossConfig:
    """Which losses are active and their static weights.

    The hard-coded phase weight schedules live in the train step
    (ref pipnet/train.py:148-177); this records the flag-driven knobs.
    """
    align: bool = True
    uni: bool = True
    align_pf: bool = False
    tanh: bool = False
    tanh_during_second_phase: bool = False
    tanh_desc: bool = True
    tanh_desc_weight: float = 0.05       # '--tanh_desc y|0.05'
    kernel_orth: bool = False
    # Per-node cap on the kernel-orth term: node contributions above the cap
    # are rescaled by cap/stop_grad(ko) so both the reported value and the
    # restoring gradient stay bounded per node.  None = reference-exact
    # (unbounded).  Why it exists (measured, runs/lou_190 seed 1): a node
    # whose per-patch softmax saturates loses every live gradient except
    # kernel_orth; the confidence runaway then grows that one node's ko to
    # O(1000), and under global/group grad-norm clipping its gradient
    # consumes the whole add-on group's clip budget, starving the other
    # nodes' learning (global grad_norm 167-200 ~= one node).
    kernel_orth_cap: Optional[float] = None
    minimize_contrasting_set: bool = False
    min_contrast_topk: int = 1
    min_contrast_weight: float = 0.1     # '--minimize_contrasting_set y|K|w'
    mask_prune_overspecific: bool = False
    mask_prune_start_epoch: int = 0
    mask_prune_boost: Optional[float] = None
    sg_before_masking: bool = True
    geometric_mean_overspecificity: bool = False
    ood_loss: bool = False               # requires an OOD loader
    ood_ent: bool = False
    weighted_ce: bool = False
    focal_loss: bool = False
    focal_loss_gamma: float = 2.0
    cl_weight: float = 2.0
    pipnet_sparsity: bool = True         # log1p(logits^m) before softmax
    byol: bool = False
    byol_tau_base: float = 0.9995
    byol_tau_max: float = 1.0
    minmaximize: bool = False
    # Epsilon inside every -log(tanh(x)+eps) term (tanh + tanh_desc).
    # None = reference-exact: 1e-8, rebound to 1e-12 whenever the
    # min-contrast block runs first (pipnet/train.py:238,1024).  Why the
    # override exists: d/dx[-log(tanh(x)+eps)] ~ -1/(x+eps), so a prototype
    # whose in-batch pooled sum is ~0 contributes a gradient of up to
    # 1/eps = 1e12 — harmless when the backbone starts from ImageNet
    # weights (the reference's only regime) but fatal from random init:
    # the measured 190-class collapse had tanh_desc ALREADY saturated at
    # -log(1e-12)=27.6 per (child, leaf) before the unfreeze, and the
    # resulting 5e8-magnitude gradient direction destroyed the backbone
    # the moment it thawed (runs/full_phase_190 forensics).  Setting e.g.
    # 1e-2 bounds that gradient at 100 while leaving satisfied terms
    # (tanh(x) >> eps) numerically unchanged to ~1e-2 relative.
    tanh_eps: Optional[float] = None
    # Epsilon inside align_pf's -log(<pf1,pf2> + eps) CARL term.  None =
    # reference-exact 1e-12 (pipnet/train.py:1399-1405).  Same random-init
    # rationale as tanh_eps: the term's gradient is ~1/(ip+eps), and the
    # measured 190-class collapse AFTER tanh_eps was bounded was driven by
    # align_pf exploding 0.23 -> 19 at the backbone unfreeze (x5 weight ~= the
    # observed ~97 total; runs/full_phase_190 forensics) — two views' softmaxed
    # maps decorrelate, ip -> 0, and the 1e12-magnitude pull dominates every
    # clipped step.  1e-2 bounds it at 100; satisfied patches (ip >> eps) are
    # numerically unchanged to ~1e-2 relative.
    align_eps: Optional[float] = None


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 0.05                     # classifier / presence
    lr_block: float = 0.0005             # trainable backbone tail; add-ons get 10x
    lr_net: float = 0.0005               # deep backbone
    weight_decay: float = 0.0
    optimizer: str = "adamw"
    # Global-norm gradient clipping; 0 = off (the reference never clips,
    # and its -log(tanh(pooled)+EPS) terms can NaN a run — it raises on
    # that, pipnet/train.py:1126-1128, rather than guarding.  Training
    # from RANDOM init (no ImageNet checkpoint was available to those runs)
    # needs a bound: every lr/phase discontinuity (classifier warm
    # restart, full backbone unfreeze) can zero some prototypes, after
    # which the ~1/pooled tanh gradients spiral.  Clipping bounds the
    # shock so the recovery pressure -log(tanh) exerts can act.)
    clip_grad: float = 0.0
    # Apply clip_grad per parameter group (backbone / freeze / train /
    # add_on / classifier / presence) instead of one shared global scale.
    # Why: the global clip factor COUPLES the groups — when the random-init
    # deep backbone thaws, its noisy gradients through 26M parameters
    # dominate the global norm (measured: raw norm 1.8 -> 10 at the
    # unfreeze epoch even with lr_net 1e-6, i.e. with negligible deep
    # UPDATES), so the tail/add-on/classifier steps all shrink ~5x at the
    # exact moment the loss landscape needs tracking.  Per-group norms
    # decouple them; mirrors clipping each torch optimizer/param-group
    # separately.  Only meaningful with clip_grad > 0.
    clip_grad_per_group: bool = False
    # Linear lr warmup (in epochs) for the DEEP-BACKBONE group after the
    # freeze_epochs unfreeze; 0 = off (the reference has none — it always
    # starts from ImageNet weights, main.py:289-348, so the unfreeze is
    # gentle there).  Why it exists here: at the unfreeze the backbone's
    # Adam moments are FRESH, and bias-corrected Adam moves every
    # parameter ~lr per step regardless of gradient magnitude — one full
    # epoch of that (measured: healthy grad 2.1 at the unfreeze epoch,
    # raw grad 59 -> 100 one epoch later, align_pf 0.23 -> 19, run dead)
    # destroys the pretrained-in-run features even under clip_grad.
    # Ramping the backbone lr 0 -> lr_net over a few epochs lets the
    # moments calibrate before the steps reach full size.
    unfreeze_warmup_epochs: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    batch_size_pretrain: int = 128
    epochs: int = 60
    epochs_pretrain: int = 10
    epochs_finetune: int = 5
    epochs_finetune_classifier: int = 3
    epochs_finetune_mask_prune: int = 999999999
    freeze_epochs: int = 10
    seed: int = 1
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    # reference quirk: check_and_update_weights matches parameter names ending
    # in '_classification', which never matches ('..._classification.weight'),
    # so the reactivation is a no-op in the reference (pipnet/train.py:67-71).
    # "off" reproduces that; "on" applies the intended +0.01 to weights <=1e-3.
    weight_reactivation: str = "off"
    data_parallel: int = 1               # number of data-parallel shards (mesh size)
    # prototype-axis model parallelism: shard the stacked prototype axis P of
    # the head params (and their optimizer state) over a second mesh axis —
    # the scaling axis for very large phylogenies (runtime/mesh.py).  1 = off.
    model_parallel: int = 1
    # ZeRO-1: shard the Adam moments over the data axis (params/grads stay
    # replicated; one extra all-gather per step for a dp-fold cut in
    # optimizer-state HBM — runtime/mesh.py:_zero1_spec).  Off by default.
    zero1: bool = False
    # device-side transform2 (ops/device_augment): the CARS recipe uses the
    # Solarize/Color space (TrivialAugmentWideNoShapeWithColor)
    device_augment_cars: bool = False


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log_dir: str = "./runs/run_pipnet"
    dataset: str = "CUB-190"
    ood_dataset: Optional[str] = None
    phylo_config: Optional[str] = None
    leave_out_classes: Optional[str] = None
    validation_size: float = 0.0
    weighted_sampler: bool = False       # --weighted_loss
    disable_transform2: bool = False
    num_workers: int = 8
