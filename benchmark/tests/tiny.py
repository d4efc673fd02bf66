"""A tiny copy of a cell for the CPU tests: a narrow ConvNeXt registered
under its own name in the port and in the reference, a flat tree of six
classes, 64^2 images, batches of four."""

from __future__ import annotations

import copy
import functools

import pytest

from benchmark import harness

TINY_BACKBONE = "convnext_bench_tiny"
DEPTHS, DIMS = (1, 1, 2, 1), (8, 16, 32, 64)


@pytest.fixture
def tiny_backbone(monkeypatch):
    """Register the narrow ConvNeXt in both packages (stochastic depth on,
    so that both draw from the step's generator)."""
    from pipnet_tpu_torch.models import convnext as port_convnext, pipnet as port_pipnet
    from benchmark.reference.pipnet_ref.models import convnext as ref_convnext
    from benchmark.reference.pipnet_ref.models import pipnet as ref_pipnet
    for mod, cn in ((port_pipnet, port_convnext), (ref_pipnet, ref_convnext)):
        ctor = functools.partial(cn.ConvNeXtTiny, stride_threshold=12, depths=DEPTHS, dims=DIMS)
        monkeypatch.setitem(mod.BACKBONES, TINY_BACKBONE, (ctor, DIMS[-1]))


def tiny_config(base: dict, classes: int = 6, protos: int = 16) -> dict:
    from pipnet_tpu_torch.tree import flat_tree
    names = [f"c{i}" for i in range(classes)]
    cfg = copy.deepcopy(base)
    m = cfg["run_config"]["model"]
    m.update(backbone=TINY_BACKBONE, image_size=64, num_features=protos, num_protos_per_child=0)
    cfg.update(classes=names, tree=flat_tree(names, protos).to_dict(), add_on_scale=4.0,
               dataset={"train_images": 24, "base_size": 72, "leave_out": []})
    cfg["published"].update(image_size=64, depths=list(DEPTHS), dims=list(DIMS),
                            stage_maps=[[16, 16, 8], [8, 8, 16], [4, 4, 32], [2, 2, 64]],
                            prototypes=protos, classes=classes, tree_nodes=1)
    return cfg


def tiny_spec(cell: str, limits: dict = None) -> dict:
    """The cell's spec with its configuration and mix cut to the tiny size."""
    bench = harness.manifest()
    spec = harness.cell_spec(cell, bench)
    spec["config_file"] = tiny_config(spec["config_file"])
    mix = dict(spec["mix"])
    if "batch" in mix:
        mix["batch"] = 4
    if "pool" in mix:
        mix.update(pool=16, checked_batches=2, warmup_batches=1)
    spec["mix"] = mix
    if limits is not None:
        spec["cell_file"] = dict(spec["cell_file"], limits=limits)
    spec["cell_file"].setdefault("threshold_band", 0.0)
    return spec
