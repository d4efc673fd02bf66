"""Run-directory CSV logging (the port's copy of the JAX package's
``runtime/log.py``, itself the counterpart of the reference's
``util/log.py:6-79``).

Layout under the run dir: ``metadata/`` (saved config, classes, tree),
``checkpoints/``, named ``<log>.csv`` files with fixed columns, and
``node_wise_metrics_{train,test}/`` per-node loss CSVs (ref
pipnet/train.py:503-518).  The files are byte for byte the JAX package's,
so either package's tools read a run of the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Sequence


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


class RunLog:
    """Takes a pid lock on the run dir: two live trainers appending to the
    same CSVs interleave their rows unusably.  A lock whose owner is dead
    is reclaimed silently.

    ``create_log`` starts each CSV afresh, as the JAX package does, so a
    resumed run (``--resume``) rewrites the CSVs from its first epoch on;
    the ``metrics_*.jsonl`` files are appended to and keep every epoch.

    Everything a run writes into its directory goes through this object:
    on a mesh only rank 0 holds one (``open_run_log``)."""

    writes = True

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.metadata_dir = os.path.join(log_dir, "metadata")
        self.checkpoint_dir = os.path.join(log_dir, "checkpoints")
        for d in (log_dir, self.metadata_dir, self.checkpoint_dir):
            os.makedirs(d, exist_ok=True)
        lock = os.path.join(log_dir, ".pipnet_lock")
        try:
            with open(lock) as f:
                owner = int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            owner = 0
        if owner and owner != os.getpid() and _pid_alive(owner):
            raise RuntimeError(
                f"run dir {log_dir!r} is in use by live process {owner} "
                f"(remove {lock} if this is stale)")
        with open(lock, "w") as f:
            f.write(str(os.getpid()))
        self._columns: Dict[str, Sequence[str]] = {}

    def save_config(self, cfg) -> None:
        """The run config as JSON (``metadata/config.json``), which
        ``run_io.load_run_config`` reads back."""
        path = os.path.join(self.metadata_dir, "config.json")
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    def save_tree(self, root) -> None:
        """The class hierarchy itself (``metadata/tree.json``), so serving
        rebuilds the exact trained topology without the phylogeny file or
        the dataset."""
        path = os.path.join(self.metadata_dir, "tree.json")
        with open(path, "w") as f:
            json.dump(root.to_dict(), f)

    def save_classes(self, classes) -> None:
        """The class-name order (``metadata/classes.json``), so serving
        rebuilds the model without the training dataset on disk."""
        path = os.path.join(self.metadata_dir, "classes.json")
        with open(path, "w") as f:
            json.dump(list(classes), f, indent=0)

    def create_log(self, name: str, *columns: str) -> None:
        if name in self._columns:
            return
        self._columns[name] = columns
        path = os.path.join(self.log_dir, f"{name}.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(",".join(columns) + "\n")

    def log_values(self, name: str, *values) -> None:
        if name not in self._columns:
            raise KeyError(f"log {name} was never created")
        if len(values) != len(self._columns[name]):
            raise ValueError(f"log {name}: expected {len(self._columns[name])} values")
        with open(os.path.join(self.log_dir, f"{name}.csv"), "a") as f:
            f.write(",".join(str(v) for v in values) + "\n")

    def message(self, msg: str) -> None:
        self.append("log.txt", msg)

    def save_checkpoint(self, name: str, model, state, **meta) -> None:
        """``checkpoints/<name>`` (``train/checkpoint.py``) of whole
        parameters and moments."""
        from ..train.checkpoint import save_checkpoint
        save_checkpoint(self.checkpoint_dir, name, model, state, **meta)

    def save_curves(self, curves: Dict[str, Sequence[float]]) -> None:
        """Each curve plotted to ``<name>.png``; skipped where matplotlib
        is not installed."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        for name, ys in curves.items():
            plt.clf()
            plt.plot(ys)
            plt.savefig(os.path.join(self.log_dir, f"{name}.png"))
        plt.close("all")

    def save_tree_picture(self, root) -> None:
        """The tree drawn to ``tree.png``, where graphviz can draw it (the
        picture is best-effort)."""
        try:
            root.save_visualization(os.path.join(self.log_dir, "tree"))
        except Exception as e:
            print(f"tree visualization skipped: {e!r}")

    def trace_dir(self, epoch: int) -> Optional[str]:
        """Where a profile of ``epoch``'s steps goes."""
        return os.path.join(self.log_dir, "traces", f"epoch_{epoch}")

    def append(self, name: str, line: str) -> None:
        """``line`` appended to the run directory's file ``name``."""
        with open(os.path.join(self.log_dir, name), "a") as f:
            f.write(line + "\n")


class NullRunLog(RunLog):
    """The run directory's paths for a rank of a mesh other than rank 0,
    which reads the directory (checkpoints to resume from) but writes
    nothing there and takes no lock: rank 0 writes the run."""

    writes = False

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.metadata_dir = os.path.join(log_dir, "metadata")
        self.checkpoint_dir = os.path.join(log_dir, "checkpoints")
        self._columns = {}

    def save_config(self, cfg) -> None:
        pass

    def save_tree(self, root) -> None:
        pass

    def save_classes(self, classes) -> None:
        pass

    def create_log(self, name: str, *columns: str) -> None:
        self._columns.setdefault(name, columns)

    def log_values(self, name: str, *values) -> None:
        pass

    def append(self, name: str, line: str) -> None:
        pass

    def save_checkpoint(self, name: str, model, state, **meta) -> None:
        pass

    def save_curves(self, curves) -> None:
        pass

    def save_tree_picture(self, root) -> None:
        pass

    def trace_dir(self, epoch: int) -> Optional[str]:
        return None


def open_run_log(log_dir: str, rank: int = 0) -> RunLog:
    """The run log of a process that is rank ``rank`` of its mesh (0
    without one): rank 0 writes the run directory, the others only read
    it (``NullRunLog``)."""
    return RunLog(log_dir) if rank == 0 else NullRunLog(log_dir)


class Tee:
    """Duplicate a stream to a file (ref main.py:869-879).  Line-buffered,
    so a killed process still leaves its progress on disk."""

    def __init__(self, path: str, stream=None):
        self.file = open(path, "a", buffering=1)
        self.stream = stream or sys.stdout

    def write(self, data):
        self.file.write(data)
        self.stream.write(data)

    def flush(self):
        self.file.flush()
        self.stream.flush()

    def close(self) -> None:
        self.file.close()
