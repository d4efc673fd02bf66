"""Adversarial prototype-relocation attack and integrated gradients.

Counterpart of the JAX package's ``interp/adversarial.py`` (itself
``adversarial/adv_attack.py:244-343`` and ``adversarial/utils.py:48-84``): a
PGD-style attack (eps=8/255, alpha=2/255, 40 steps) on one image trying to
MOVE a prototype's peak activation away from its original location into
low-activation regions.  Success (peak lands in the adversarial mask)
indicates a non-robust prototype.

Each step is a forward (K1 on the card) and a gradient with respect to the
image through the whole model (K1b, then the projection and backbone
adjoints), at B = 1; the model's parameters are frozen for the attack, so
nothing computes their gradients.  The steps run eagerly, one after the
other, with no host read between them: the attack reads from the device
only at its end.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.augment import IMAGENET_MEAN, IMAGENET_STD
from ..models.pipnet import PIPNet


def adversarial_locs_mask(activation: torch.Tensor, threshold: float = 0.4,
                          window: int = 5) -> torch.Tensor:
    """Low-activation target mask (H, W) bool: everywhere the activation <=
    threshold, excluding a (window x window) box around the current peak
    (ref adversarial/utils.py:48-70).  Computed on ``activation``'s device
    without a host read."""
    H, W = activation.shape
    idx = torch.argmax(activation.reshape(-1))
    ph, pw = idx // W, idx % W
    hh = torch.arange(H, device=activation.device)[:, None]
    ww = torch.arange(W, device=activation.device)[None, :]
    half = window // 2
    near_peak = ((hh - ph).abs() <= half) & ((ww - pw).abs() <= half)
    return (~near_peak) & (activation <= threshold)


def _relocation_loss(activation: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean(act * mask) - mean(act * ~mask)  (ref adv_attack.py:326-334);
    minimized, i.e. activation is pushed OUT of the masked target zone by the
    SGD step on the image — the attack then checks whether the peak moved."""
    m = mask.to(activation.dtype)
    return torch.mean(activation * m) - torch.mean(activation * (1.0 - m))


@contextlib.contextmanager
def _frozen(model: torch.nn.Module):
    """The model's parameters without ``requires_grad`` while the block runs."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _image_stats(device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def _on_device(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def adversarial_attack(model: PIPNet, x_norm, proto_idx: int, *, num_steps: int = 40,
                       epsilon: float = 8 / 255, alpha: float = 2 / 255,
                       threshold: float = 0.4, window: int = 5,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[bool, np.ndarray]:
    """Attack one normalized image (H,W,3) on prototype ``proto_idx``.  With
    ``generator`` the image starts from a uniform random point of the
    eps-ball drawn from it (on the generator's device).

    Returns (peak_relocated, adversarial image in [0,1] pixel space)."""
    dev = next(model.parameters()).device
    mean, std = _image_stats(dev)

    def proto_map(img01):
        out = model(((img01 - mean) / std)[None], train=False)
        return out["proto_features"][0, :, :, proto_idx]

    with _frozen(model):
        x01 = torch.clamp(_on_device(x_norm, dev) * std + mean, 0.0, 1.0)
        with torch.no_grad():
            mask = adversarial_locs_mask(proto_map(x01), threshold, window)
        img = x01
        if generator is not None:
            noise = torch.rand(img.shape, generator=generator, device=generator.device)
            img = torch.clamp(img + (noise.to(dev) * (2 * epsilon) - epsilon), 0.0, 1.0)
        for _ in range(num_steps):
            im = img.detach().requires_grad_()
            g, = torch.autograd.grad(_relocation_loss(proto_map(im), mask), im)
            img = im.detach() - alpha * g                               # SGD on the loss
            img = x01 + torch.clamp(img - x01, -epsilon, epsilon)       # eps-ball
            img = torch.clamp(img, 0.0, 1.0)
        with torch.no_grad():
            peak = torch.argmax(proto_map(img).reshape(-1))
            moved = mask.reshape(-1)[peak]
        moved, adv = bool(moved.item()), img.cpu().numpy()
    return moved, adv


def integrated_gradients_patch(model: PIPNet, x_norm, proto_idx: int, *,
                               num_steps: int = 50) -> torch.Tensor:
    """Integrated-gradients localization of the image region responsible for a
    prototype's pooled activation (counterpart of
    plot_proto_activations_using_gradients.py:152-211): IG of pooled[p] from a
    black baseline, attribution summed over channels -> (H, W) saliency on
    the model's device."""
    dev = next(model.parameters()).device
    x = _on_device(x_norm, dev)
    baseline = torch.zeros_like(x)
    total = torch.zeros_like(x)
    with _frozen(model):
        for i in range(num_steps):
            a = (i + 0.5) / num_steps
            im = (baseline + a * (x - baseline)).requires_grad_()
            pooled = model(im[None], train=False)["pooled"]
            g, = torch.autograd.grad(pooled[0, proto_idx], im)
            total = total + g
    ig = (x - baseline) * total / num_steps
    return ig.abs().sum(dim=-1)                # (H, W) saliency
