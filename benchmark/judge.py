"""The comparison that decides ``correct``: the numbers taken from the
program's outputs and the reference's, each held to its limit from the
cell's file in ``benchmark/workloads``."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping, Sequence

import numpy as np

# a leaf whose first gradient in the reference is under this share of the
# median leaf's moves under AdamW by rounding alone: its change is not compared
STILL_LEAF = 1e-3


def _gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor, 1e-30)


def train_numbers(program: Mapping, reference: Mapping) -> Dict[str, float]:
    """``loss_rel_gap``: the largest gap of a step's loss, over the
    reference's; ``loss1_rel_gap``: the same of the first step's loss alone
    (no update has acted yet); ``grad_norm_gap``: the worst leaf's gap of first-gradient
    norms, over the reference's norm of that leaf or of the median leaf,
    whichever is larger; ``change_norm_gap``: the same of the change after
    the steps, over the leaves whose reference gradient is not nought to
    rounding (``STILL_LEAF``)."""
    losses = [_gap(p, r, 0.0) for p, r in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(math.inf)
    g_ref, g_got = reference["grad"], program["grad"]
    moving = [v for v in g_ref.values() if v > 0]
    g_med = statistics.median(moving) if moving else 0.0
    grad = [_gap(g_got.get(n, math.inf), g_ref[n], g_med) for n in g_ref]
    kept = [n for n in g_ref if g_ref[n] >= STILL_LEAF * g_med and g_ref[n] > 0]
    c_ref, c_got = reference["change"], program["change"]
    c_med = statistics.median([c_ref[n] for n in kept]) if kept else 0.0
    change = [_gap(c_got.get(n, math.inf), c_ref[n], c_med) for n in kept]
    return {"loss_rel_gap": _worst(losses), "loss1_rel_gap": _worst(losses[:1]),
            "grad_norm_gap": _worst(grad),
            "change_norm_gap": _worst(change)}


def train_diagnostics(program: Mapping, reference: Mapping) -> Dict:
    """What the limits were set from, beside ``train_numbers``: each step's
    loss gap, the median leaf's gaps and the worst leaves' names."""
    g_ref, c_ref = reference["grad"], reference["change"]
    moving = [v for v in g_ref.values() if v > 0]
    g_med = statistics.median(moving) if moving else 0.0
    grad = {n: _gap(program["grad"].get(n, math.inf), g_ref[n], g_med) for n in g_ref}
    kept = [n for n in g_ref if g_ref[n] >= STILL_LEAF * g_med and g_ref[n] > 0]
    c_med = statistics.median([c_ref[n] for n in kept]) if kept else 0.0
    change = {n: _gap(program["change"].get(n, math.inf), c_ref[n], c_med) for n in kept}
    return {"loss_gaps": [_gap(p, r, 0.0) for p, r in zip(program["losses"],
                                                         reference["losses"])],
            "grad_median_leaf": statistics.median(grad.values()),
            "change_median_leaf": statistics.median(change.values()) if change else math.inf,
            "grad_worst": sorted(grad, key=grad.get)[-3:],
            "change_worst": sorted(change, key=change.get)[-3:],
            "leaves": len(g_ref), "kept": len(kept)}


def serve_numbers(program_logp: np.ndarray, reference_logp: np.ndarray) -> Dict[str, float]:
    """``prob_tv_gap``: over the sample's images, the largest
    total-variation distance between the served joint leaf distribution and
    the reference's."""
    lp = np.asarray(program_logp, np.float64)
    lr = np.asarray(reference_logp, np.float64)
    if lp.shape != lr.shape:
        return {"prob_tv_gap": math.inf}
    return {"prob_tv_gap": _worst(0.5 * np.abs(np.exp(lp) - np.exp(lr)).sum(axis=1))}


def _worst(values: Sequence[float]) -> float:
    values = [float(v) for v in values]
    if not values:
        return math.inf
    return math.inf if any(not math.isfinite(v) for v in values) else max(values)


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict:
    """``{name: {"value", "limit"}}`` for every limit, and whether each
    number is finite and within its limit."""
    checks = {n: {"value": float(numbers.get(n, math.inf)), "limit": float(lim)}
              for n, lim in limits.items()}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return {"correct": ok, "checks": checks}
