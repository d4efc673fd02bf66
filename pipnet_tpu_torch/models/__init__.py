"""Models: the ConvNeXt, ResNet and DINOv2 backbones, BYOL's heads and the
stacked prototype-head PIPNet."""

from .byol import PatchMLP, byol_tau_schedule, ema_update, init_byol_state
from .convert import (byol_state_from_jax, opt_state_from_jax, params_from_jax,
                      random_jax_params, random_jax_variables, state_dict_from_jax)
from .convnext import (ConvNeXtTiny, convnext_param_groups, convnext_tiny_7,
                       convnext_tiny_13, convnext_tiny_26)
from .heads import PrototypeHead
from .pipnet import (BACKBONES, PIPNet, assign_prototype_budgets, build_pipnet,
                     degenerate_nodes_traced, joint_leaf_distribution,
                     joint_leaf_log_distribution, latent_shape, masked_decode_degenerates,
                     presence_keep)
from .resnet import (BatchNorm, ResNetFeatures, resnet18_features, resnet34_features,
                     resnet50_features, resnet50_features_inat, resnet101_features,
                     resnet152_features, resnet_param_groups)
from .vit import DinoV2ViT, dinov2_vits14, vit_param_groups

__all__ = [
    "ConvNeXtTiny", "convnext_tiny_26", "convnext_tiny_13", "convnext_tiny_7",
    "convnext_param_groups", "opt_state_from_jax",
    "PrototypeHead", "PIPNet", "BACKBONES", "assign_prototype_budgets",
    "build_pipnet", "degenerate_nodes_traced", "joint_leaf_distribution",
    "joint_leaf_log_distribution", "latent_shape", "masked_decode_degenerates",
    "presence_keep",
    "params_from_jax", "random_jax_params", "random_jax_variables", "state_dict_from_jax",
    "byol_state_from_jax", "PatchMLP", "byol_tau_schedule", "ema_update", "init_byol_state",
    "BatchNorm", "ResNetFeatures", "resnet18_features", "resnet34_features",
    "resnet50_features", "resnet50_features_inat", "resnet101_features",
    "resnet152_features", "resnet_param_groups", "DinoV2ViT", "dinov2_vits14",
    "vit_param_groups",
]
