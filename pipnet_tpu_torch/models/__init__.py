"""Models: ConvNeXt backbones and the stacked prototype-head PIPNet."""

from .convert import params_from_jax, random_jax_params
from .convnext import (ConvNeXtTiny, convnext_tiny_7, convnext_tiny_13,
                       convnext_tiny_26)
from .heads import PrototypeHead
from .pipnet import (BACKBONES, PIPNet, assign_prototype_budgets, build_pipnet,
                     joint_leaf_log_distribution, latent_shape)

__all__ = [
    "ConvNeXtTiny", "convnext_tiny_26", "convnext_tiny_13", "convnext_tiny_7",
    "PrototypeHead", "PIPNet", "BACKBONES", "assign_prototype_budgets",
    "build_pipnet", "joint_leaf_log_distribution", "latent_shape",
    "params_from_jax", "random_jax_params",
]
