"""The port's train step on a (2, 2) mesh of four gloo ranks (two rows a
data rank, half the head's columns a model rank) against the one-process
step: the runs of ``torch_mesh_util.MODEL_SCENARIOS`` that exercise the data
axis beside the model axis, at the bars of ``tests/test_torch_mesh.py``."""

import pytest

import torch_mesh_util as U

WORLD, N_MODEL = 4, 2
# the feature losses (with OOD rows) and BYOL as two runs, as on the data
# mesh (test_torch_mesh.py): together on two data ranks the second step's
# weights differ by a few lr-scaled ulps where the first step's Adam signs
# flip at rounding, on the data mesh alone as much
RUNS = ("cut", "no_cut", "align_uniform_ood", "byol", "zero1", "resnet18")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = [{**U.SCENARIOS, **U.MODEL_SCENARIOS}[n]() for n in RUNS]
    return (U.run_ranks(runs, WORLD, tmp_path_factory.mktemp("mesh22"), n_model=N_MODEL),
            U.one_process(runs))


@pytest.mark.parametrize("name", RUNS)
def test_two_by_two_mesh_equals_one_process(ranks, name):
    got, want = ranks
    U.check_run(name, got, want[name])
