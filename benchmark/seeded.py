"""Inputs made from ``--seed`` on the device: weights in the port's
state_dict layout, uint8 training bases and normalised serving images.

Everything is drawn with one ``torch.Generator`` on the run's device in a
few large calls, so set-up spends no time on the host, and the same seed
gives the same tensors to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# the streams of one seed: weights, images, the train step's own generator
WEIGHTS, IMAGES, STEP = 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
    """The seed of one kind of input: ``--seed`` and the stream number
    mixed, so that weights, images and the step's draws never share one."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float, float]:
    """(kind, a, b) of a leaf: ``normal`` a + b N(0, 1), ``uniform`` on
    [a, b], ``const`` a.  The scales are those of the port's
    ``models/convert.py::random_jax_variables``: 1/sqrt(fan_in) normals for
    kernels, small biases, norm scales near 1, layer scales in [0.05, 0.2]."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("head.multiplier"):
        return "const", 2.0, 0.0
    if leaf == "layer_scale":
        return "uniform", 0.05, 0.2
    if leaf in ("norm_scale",) or (leaf == "weight" and "norm" in name and len(shape) == 1):
        return "normal", 1.0, 0.05
    if len(shape) == 1:
        return "normal", 0.0, 0.02
    fan_in = int(np.prod(shape[1:]))       # nn.Conv2d (out, in/groups, kh, kw), nn.Linear (out, in)
    return "normal", 0.0, fan_in ** -0.5


def seeded_state_dict(shapes: Mapping[str, Tuple[int, ...]], tree, seed: int, device,
                      add_on_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """f32 weights for every leaf of ``shapes`` (the model's state_dict
    shapes).  The head follows the port's initialisation: the add-on kernel
    xavier-uniform (times ``add_on_scale``), the classifier N(1, 0.1) inside
    each child's block of prototypes and -0.5 outside, the presence logits
    N(0, 2 / (n + 2)) for a node of n prototypes.  ``tree`` is the
    reference's compiled tree (its ``child_block_mask`` and node slices)."""
    g = generator(seed, device, WEIGHTS)
    names = sorted(shapes)
    numel = {n: int(np.prod(shapes[n])) for n in names}
    normal = torch.randn(sum(numel.values()), generator=g, device=device)
    uniform = torch.rand(sum(numel.values()), generator=g, device=device)
    out, at = {}, 0
    for n in names:
        shape, k = tuple(shapes[n]), numel[n]
        z, u = normal[at:at + k].view(shape), uniform[at:at + k].view(shape)
        at += k
        if n.endswith("head.add_on_kernel"):
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[n] = (u * 2.0 - 1.0) * (limit * add_on_scale)
        elif n.endswith("head.cls_weight"):
            mask = torch.as_tensor(tree.child_block_mask, device=device) > 0
            out[n] = torch.where(mask, 1.0 + 0.1 * z, torch.full_like(z, -0.5))
        elif n.endswith("head.proto_presence"):
            std = np.ones(shape[0], np.float32)
            for ni in range(tree.num_nodes):
                std[tree.node_proto_slice(ni)] = math.sqrt(
                    2.0 / (int(tree.node_num_protos[ni]) + 2))
            out[n] = z * torch.as_tensor(std, device=device)[:, None]
        else:
            kind, a, b = _rule(n, shape)
            if kind == "const":
                out[n] = torch.full(shape, a, device=device)
            elif kind == "uniform":
                out[n] = a + (b - a) * u
            else:
                out[n] = a + b * z
        out[n] = out[n].float().contiguous()
    return out


def u8_bases(n: int, size: int, seed: int, device, chunk: int = 256) -> torch.Tensor:
    """(n, size, size, 3) uint8 images: each three colour ramps plus noise,
    as the port's synthetic fixture draws them, made on the device."""
    g = generator(seed, device, IMAGES)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    ramp = torch.arange(size, device=device, dtype=torch.float32) / size
    yy, xx = ramp[:, None, None], ramp[None, :, None]
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        c = torch.rand((m, 3, 1, 1, 3), generator=g, device=device) * 255.0
        base = (c[:, 0] * xx + c[:, 1] * yy + c[:, 2] * (1 - xx) * (1 - yy)) / 2
        noise = torch.randn((m, size, size, 3), generator=g, device=device) * 20.0
        out[lo:lo + m] = (base + noise).clamp_(0, 255).to(torch.uint8)
    return out


def normalised_images(n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size, 3) f32 images as the serving path takes them: seeded
    uint8 images scaled to [0, 1] and ImageNet-normalised."""
    x = u8_bases(n, size, seed, device).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return (x - mean) / std


def epoch_rows(n_images: int, batch: int, seed: int, epoch: int) -> Sequence[np.ndarray]:
    """One epoch's batches of image rows: a permutation drawn from the seed
    and the epoch, cut into whole batches."""
    perm = np.random.default_rng([int(seed), int(epoch)]).permutation(n_images)
    return [perm[i:i + batch] for i in range(0, n_images - batch + 1, batch)]
