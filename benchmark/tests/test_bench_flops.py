"""The yardstick's counts against hand counts."""

from __future__ import annotations

import pytest

from benchmark import flops, harness

PUB = harness.load_json(f"{harness.BENCH_DIR}/configs/hcompnet_cub190.json")["published"]


def test_one_block_by_hand():
    """Stage 3's first block at 26 x 26 x 768: the depthwise 7 x 7 taps
    (49 C) and the MLP's two products (C x 4C each) at every pixel."""
    layers = {l.name: l for l in flops.convnext_layers(224, PUB["depths"], PUB["dims"])}
    assert layers["stage3_block0"].macs == 26 * 26 * (49 * 768 + 768 * 3072 + 3072 * 768)
    assert layers["down3_conv"].macs == 26 * 26 * (2 * 2 * 384 * 768)
    assert layers["stem_conv"].macs == 56 * 56 * (4 * 4 * 3 * 96)


def test_stage_maps_follow_the_stride_surgery():
    assert flops.latent_side(224, PUB["depths"], PUB["dims"]) == 26
    assert [m[0] for m in PUB["stage_maps"]] == [56, 28, 27, 26]


def test_forward_and_step_totals():
    """~20.05 GMAC of backbone and 1.96 of head a 224^2 image; the
    flagship step (64 images in two views, stem and stages 0-1 frozen)
    ~16.1 TFLOP.  bench.py's 31.5 TFLOP a step (the JAX package's, an
    assumed count) is not borne out: a backward of everything at three
    times the forward would give ~17.0."""
    layers = flops.convnext_layers(224, PUB["depths"], PUB["dims"])
    assert sum(l.macs for l in layers) == pytest.approx(20.05e9, rel=2e-3)
    step = flops.model_flops(PUB, 3780, 378, 128, training=True)
    assert step == pytest.approx(16.1e12, rel=1e-2)
    forward = flops.model_flops(PUB, 3780, 378, 128, training=False)
    assert 3 * forward == pytest.approx(17.0e12, rel=1e-2)
    assert step < 3 * forward < 31.5e12


def test_uniformity_pairs():
    n, d = 64 * 26 * 26, 768
    assert flops.uniformity_flops(n, d) == pytest.approx(2 * 2 * d * 1.5 * n * n, rel=1e-4)


def test_bounds_use_the_larger_of_bytes_and_operations():
    nbytes, ops = flops.k1_cost(128 * 676, 768, 3780, 128)
    assert flops.bound_s(nbytes, bf16_ops=ops) == pytest.approx(
        max(nbytes / 3.35e12, ops / 989e12))
    assert flops.bound_s(1e9, f32_ops=67e12) == pytest.approx(1.0)
