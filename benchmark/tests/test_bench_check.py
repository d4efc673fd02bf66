"""The comparison that decides ``correct``, on the CPU at a tiny size: the
frozen reference equals the port where both compute alike, and a run with
the timed path broken underneath (each fault a cell can have), or the
control in the program's place, comes out not correct under the cell's own
limits.  The readings at the cells' own sizes, which set those limits, are
the card's (``benchmark/calibrate.py``; ``PERF.md``)."""

from __future__ import annotations

import subprocess
import sys
import time

import pytest

from benchmark import harness, judge
from benchmark.tests.tiny import tiny_backbone, tiny_spec  # noqa: F401  (fixture)

SEED = 2 ** 31 + 12345
TRAIN = "hcompnet_cub190.train_joint"
SERVE = "hcompnet_cub190.serve_b64"


def _limits(cell):
    return harness.cell_spec(cell, harness.manifest())["cell_file"]["limits"]


def _run(cell, fault=None):
    spec = tiny_spec(cell, limits=_limits(cell))
    return harness.run_cell(spec, harness.manifest(), SEED, 0.5, False, "cpu",
                            time.perf_counter(), fault=fault)


def test_the_reference_is_the_port_in_float32(tiny_backbone):
    """With the program in float32 too, the two differ only by the head's
    summation order (the port's K1 path runs its plain version on the
    CPU; the reference the composed head): the copy is faithful."""
    spec = tiny_spec(TRAIN)
    spec["config_file"]["run_config"]["model"]["compute_dtype"] = "float32"
    cell = harness.driver(spec).Cell(spec, SEED, "cpu")
    cell.setup()
    cell.release()
    numbers = cell.numbers(cell.reference())
    assert numbers["loss_rel_gap"] < 1e-6, numbers
    assert numbers["grad_norm_gap"] < 1e-4, numbers
    assert numbers["change_norm_gap"] < 1e-4, numbers


@pytest.mark.parametrize("cell,fault", [(TRAIN, "unchanged"), (TRAIN, "half_batch"),
                                        (SERVE, "answer"), (SERVE, "half_batch")])
def test_a_broken_timed_path_is_not_correct(tiny_backbone, cell, fault):
    result = _run(cell, fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_the_control_is_not_correct(tiny_backbone, cell):
    """The reference one precision below the configuration's (bfloat16
    with e4m3 products) put in the program's place reads above the
    cell's limits, and above the program's own readings."""
    spec = tiny_spec(cell, limits=_limits(cell))
    drv = harness.driver(spec)
    c = drv.Cell(spec, SEED, "cpu")
    c.setup()
    c.window(0.0 if drv.Cell.kind == "train" else 0.5)
    c.release()
    ref = c.reference()
    program = c.numbers(ref)
    if drv.Cell.kind == "train":
        control = judge.train_numbers(c.reference(c.spec["cell_file"]["control"]), ref)
        assert control["loss_rel_gap"] > 3 * program["loss_rel_gap"], (control, program)
    else:
        low = c.answers(c.spec["cell_file"]["control"])
        control = c.numbers(c.reference(served=low), served=low)
        assert control["prob_tv_gap"] > 3 * program["prob_tv_gap"], (control, program)
    assert judge.verdict(control, _limits(cell))["correct"] is False, control


def test_no_card_no_result():
    """Without a CUDA card the command prints nothing on standard output
    and exits non-zero (it never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", TRAIN, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.manifest()
    result = harness.run_cell(harness.cell_spec(TRAIN, bench), bench, SEED, 2.0, False, "cuda",
                              time.perf_counter())
    assert result["correct"], result["checks"]
