"""Models: ConvNeXt backbones and the stacked prototype-head PIPNet."""

from .convert import opt_state_from_jax, params_from_jax, random_jax_params
from .convnext import (ConvNeXtTiny, convnext_param_groups, convnext_tiny_7,
                       convnext_tiny_13, convnext_tiny_26)
from .heads import PrototypeHead
from .pipnet import (BACKBONES, PIPNet, assign_prototype_budgets, build_pipnet,
                     degenerate_nodes_traced, joint_leaf_distribution,
                     joint_leaf_log_distribution, latent_shape, masked_decode_degenerates,
                     presence_keep)

__all__ = [
    "ConvNeXtTiny", "convnext_tiny_26", "convnext_tiny_13", "convnext_tiny_7",
    "convnext_param_groups", "opt_state_from_jax",
    "PrototypeHead", "PIPNet", "BACKBONES", "assign_prototype_budgets",
    "build_pipnet", "degenerate_nodes_traced", "joint_leaf_distribution",
    "joint_leaf_log_distribution", "latent_shape", "masked_decode_degenerates",
    "presence_keep",
    "params_from_jax", "random_jax_params",
]
