"""Checkpoints of a training run (the port's counterpart of the JAX
package's ``train/checkpoint.py``, which replaces the reference's
``torch.save`` dict and its parse-the-epoch-from-the-filename resume,
``main.py:703-724``, ``main_dist.py:405-408``).

A checkpoint ``<name>`` under ``<log_dir>/checkpoints`` is two files:

* ``<name>.pt``: the model's bare ``state_dict``, the file
  ``run_io.load_run`` reads;
* ``<name>.state.pt``: the rest of the train state beside it: each
  parameter's Adam moments and step count, the ``torch.Generator`` state,
  the run metadata (``epoch``, ``phase``) and the SHA-256 of the weights
  file it belongs to.

Only a save that a crash cut leaves ``.new`` files behind; without them
the final pair is whole by construction (``save_checkpoint``), so finding
a checkpoint or reading its metadata loads no tensor and hashes nothing.
The metadata is read from a memory map of the state file, so the moments
are not read either.

Names follow the reference's cadence: ``net_pretrained``, ``net_trained``,
``net_trained_<E>``, ``net_trained_last``.  Both files are written with
``torch.save`` and read with ``torch.load(weights_only=True)``: tensors,
numbers and strings only.
"""

from __future__ import annotations

import glob
import hashlib
import io
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .optimizer import AdamState
from .step import TrainState

WEIGHTS, STATE = ".pt", ".state.pt"


def _paths(path: str) -> Tuple[str, str]:
    p = os.path.abspath(path)
    if p.endswith(WEIGHTS):
        p = p[: -len(WEIGHTS)]
    return p + WEIGHTS, p + STATE


def _serialize(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _write(path: str, data: bytes) -> None:
    """``data`` to ``path`` through a temporary name: a reader finds the
    whole file or none."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _sha256(path: str) -> Optional[str]:
    if not os.path.exists(path):
        return None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _load(path: str, mmap: bool = False):
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def resolve_checkpoint(path: str) -> Optional[Tuple[str, str]]:
    """(weights file, state file) of the complete checkpoint ``path``
    (``checkpoints/<name>``, with or without ``.pt``), surviving a crash at
    any point of a save; None if there is none.  A state file is complete by
    construction (written through a temporary name) and names by SHA-256
    the weights it belongs to.  A ``<name>.state.pt.new`` is a finished save
    not yet swapped in: it is newer than the final pair and wins, with the
    weights it names (``.pt.new``, or ``.pt`` once swapped).  Without it the
    final pair is the checkpoint, read without a hash: a weights file
    without its state is an unfinished save and is ignored."""
    weights, state = _paths(path)
    if os.path.exists(state + ".new"):
        sha = _load(state + ".new", mmap=True)["weights_sha256"]
        for w in (weights + ".new", weights):
            if os.path.exists(w) and _sha256(w) == sha:
                return w, state + ".new"
    if os.path.exists(weights) and os.path.exists(state):
        return weights, state
    return None


def _finish_interrupted_save(path: str) -> None:
    """Complete a save that a crash cut after its state file landed
    (promote, never delete, the newest complete checkpoint), then drop what
    an unfinished save left (a ``.new`` without its state, a partial
    temporary file)."""
    weights, state = _paths(path)
    leftovers = [p for p in (weights + ".new", state + ".new") if os.path.exists(p)]
    leftovers += glob.glob(glob.escape(weights) + ".new.*.tmp")
    leftovers += glob.glob(glob.escape(state) + ".new.*.tmp")
    if not leftovers:
        return
    found = resolve_checkpoint(path)
    if found is not None and found[1] == state + ".new":
        if found[0] != weights:
            os.replace(found[0], weights)
        os.replace(found[1], state)
    for leftover in leftovers:
        if os.path.exists(leftover):
            os.remove(leftover)


def save_checkpoint(checkpoint_dir: str, name: str, model: torch.nn.Module,
                    state: TrainState, **meta) -> str:
    """Write checkpoint ``name``: the model's ``state_dict`` and the train
    state beside it, with ``meta`` (``epoch``, ``phase``, ...).

    Crash-safe overwrite.  Both files are written in full to ``.new`` names
    before either final name is touched, the weights first and the state
    file LAST: the state file is the commit record, naming by SHA-256 the
    weights it belongs to.  Then the weights and the state are swapped in,
    in that order.  A crash before the state file lands leaves the previous
    pair whole (the weights without their state are dropped at the next
    save or ignored at a restore); a crash after it leaves a finished save
    that ``resolve_checkpoint`` finds and the next save promotes.  Between
    the two swaps ``<name>.pt`` is already the new, complete weights file,
    so ``run_io.load_run`` never reads a torn file.  Returns the path
    without suffix."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, name)
    weights, state_path = _paths(path)
    _finish_interrupted_save(path)
    blob = _serialize({k: v.detach().cpu() for k, v in model.state_dict().items()})
    opt = state.opt
    record = {
        "weights_sha256": hashlib.sha256(blob).hexdigest(),
        "meta": dict(meta),
        "opt_mu": {n: t.detach().cpu() for n, t in opt.mu.items()},
        "opt_nu": {n: t.detach().cpu() for n, t in opt.nu.items()},
        "opt_count": dict(opt.count),
        "generator": state.generator.get_state(),
    }
    _write(weights + ".new", blob)
    _write(state_path + ".new", _serialize(record))
    os.replace(weights + ".new", weights)
    os.replace(state_path + ".new", state_path)
    return os.path.abspath(path)


def checkpoint_meta(path: str) -> Optional[Dict[str, Any]]:
    """The run metadata of checkpoint ``path``, read from a memory map of
    its state file (no tensor is read); None if no complete checkpoint
    exists there."""
    found = resolve_checkpoint(path)
    if found is None:
        return None
    return dict(_load(found[1], mmap=True)["meta"])


def latest_train_checkpoint(checkpoint_dir: str):
    """(path, meta) of the NEWEST restorable train-phase checkpoint by
    recorded epoch: the rolling ``net_trained`` and any ``net_trained_<E>``
    or ``net_trained_last``, with ``net_trained`` winning ties.  With
    ``--checkpoint_every > 1`` a periodic snapshot can be newer than the
    rolling save.  (None, {}) when nothing restorable exists."""
    names = set()
    if os.path.isdir(checkpoint_dir):
        for entry in os.listdir(checkpoint_dir):
            base = entry.removesuffix(".new")
            for suffix in (STATE, WEIGHTS):
                if base.endswith(suffix):
                    base = base[: -len(suffix)]
                    break
            else:
                continue
            if base == "net_trained" or base.startswith("net_trained_"):
                names.add(base)
    best = None
    for name in sorted(names):
        p = os.path.join(checkpoint_dir, name)
        meta = checkpoint_meta(p)
        if meta is None:
            continue
        key = (int(meta.get("epoch", -1)), name == "net_trained")
        if best is None or key > best[0]:
            best = (key, p, meta)
    return (best[1], best[2]) if best else (None, {})


def _load_weights(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    found = resolve_checkpoint(path)
    if found is None:
        raise FileNotFoundError(f"no complete checkpoint at {path}")
    return _load(found[0]), _load(found[1])


def _copy_into(params: Dict[str, torch.Tensor], tensors: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(tensors) != set(params):
        raise KeyError(f"{what}: names differ from the model's: "
                       f"{sorted(set(tensors) ^ set(params))[:8]}")
    with torch.no_grad():
        for n, t in tensors.items():
            if t.shape != params[n].shape:
                raise ValueError(f"{what}: {n} has shape {tuple(t.shape)}, the model "
                                 f"{tuple(params[n].shape)}")
            params[n].copy_(t)


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore checkpoint ``path`` into ``state``: the weights into its
    parameters (the model's own tensors, in place), the Adam moments and
    counts and the generator state; returns (state, meta)."""
    weights, record = _load_weights(path)
    _copy_into(state.params, weights, "weights")
    mu = {n: torch.empty_like(p) for n, p in state.params.items()}
    nu = {n: torch.empty_like(p) for n, p in state.params.items()}
    _copy_into(mu, record["opt_mu"], "Adam first moments")
    _copy_into(nu, record["opt_nu"], "Adam second moments")
    count = {n: int(c) for n, c in record["opt_count"].items()}
    if set(count) != set(state.params):
        raise KeyError("Adam counts: names differ from the model's")
    state.generator.set_state(record["generator"])
    state.opt = AdamState(mu=mu, nu=nu, count=count)
    return state, dict(record["meta"])


def load_backbone_only(path: str, state: TrainState) -> TrainState:
    """Partial load of the backbone and the add-on, as
    ``--state_dict_dir_backbone`` (main.py:319-348): everything else
    (classifier, presence) keeps its fresh init, the Adam state is
    untouched, and the multiplier is pinned to 2.0."""
    weights, _ = _load_weights(path)
    keep = {n: t for n, t in weights.items()
            if n.startswith("backbone.") or n in ("head.add_on_kernel", "head.add_on_bias")}
    with torch.no_grad():
        for n, t in keep.items():
            if n in state.params:
                state.params[n].copy_(t)
        state.params["head.multiplier"].fill_(2.0)
    return state
