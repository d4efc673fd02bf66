"""Dataset registry (the port's copy of the JAX package's ``datasets.py``).

The reference hard-codes cluster filesystem paths per dataset name
(``util/data.py:126-425``).  Here a name resolves through, in order:

1. ``synthetic[:N[:K[:sS]]]`` — the built-in generated fixture (N classes, K
   images a class, fixture seed S), generated once into
   ``$TMPDIR/pipnet_tpu_synth_v<version>_<N>_<K>_<seed>``: the same
   directory and the same files as the JAX package's, so a run config's
   saved ``phylo_config`` resolves with either package;
2. ``folder:<train_dir>:<test_dir>[:<project_dir>]`` — explicit paths;
3. ``$PIPNET_DATA_ROOT/<name>/{train,test}`` — a conventional layout for the
   named datasets (CUB-190, INAT-BIRDS, FV, CARS, PETS, ...).

Returns (train_dir, test_dir, project_dir, transform kwargs).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

_CARS_LIKE = {"CARS"}
_GRAYSCALE = {"grayscale"}


def synthetic_root(n_classes: int, per_class: int, seed: int) -> str:
    from .data.synthetic import FIXTURE_VERSION
    return os.path.join(tempfile.gettempdir(),
                        f"pipnet_tpu_synth_v{FIXTURE_VERSION}_{n_classes}_{per_class}_{seed}")


def _ensure_synthetic(root: str, n_classes: int, per_class: int, seed: int) -> None:
    """Generate the fixture into a private directory and rename it into
    place, so a reader never sees a partial fixture; when another process
    got there first its (identical) fixture is kept."""
    if os.path.exists(os.path.join(root, "phylogeny.phy")):
        return
    from .data.synthetic import generate_synthetic_dataset
    tmp = f"{root}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    generate_synthetic_dataset(tmp, num_classes=n_classes, images_per_class=per_class,
                               seed=seed)
    try:
        os.rename(tmp, root)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        if not os.path.exists(os.path.join(root, "phylogeny.phy")):
            raise


def resolve_dataset(name: str, *, seed: int = 1) -> Tuple[str, str, Optional[str], Dict]:
    kwargs: Dict = {}
    if name.startswith("synthetic"):
        # 'synthetic[:N[:K[:sS]]]' — N classes, K images/class, optional
        # fixture seed override (an OOD fixture must be generated with a
        # DIFFERENT seed so its class cues are disjoint from the
        # in-distribution fixture's)
        parts = name.split(":")
        n_classes = int(parts[1]) if len(parts) > 1 else 8
        per_class = int(parts[2]) if len(parts) > 2 else 8
        if len(parts) > 3 and parts[3].startswith("s"):
            seed = int(parts[3][1:])
        root = synthetic_root(n_classes, per_class, seed)
        _ensure_synthetic(root, n_classes, per_class, seed)
        kwargs["phylo_path"] = os.path.join(root, "phylogeny.phy")
        return os.path.join(root, "train"), os.path.join(root, "test"), None, kwargs

    if name.startswith("folder:"):
        parts = name.split(":")[1:]
        # an empty test segment ("folder:<train>:") means "no test directory":
        # build_loaders then carves a validation_size stratified split of
        # the train folder (ref util/data.py:663-668)
        train, test = parts[0], (parts[1] or None)
        project = parts[2] if len(parts) > 2 else None
        return train, test, project, kwargs

    root = os.environ.get("PIPNET_DATA_ROOT")
    if root is None:
        raise FileNotFoundError(
            f"dataset {name!r}: set PIPNET_DATA_ROOT to a directory containing "
            f"{name}/train and {name}/test, or use 'folder:<train>:<test>' / "
            "'synthetic[:N[:K]]'")
    base = os.path.join(root, name)
    if any(c in name for c in _CARS_LIKE):
        kwargs["cars"] = True
    if name in _GRAYSCALE:
        kwargs["grayscale"] = True
    return os.path.join(base, "train"), os.path.join(base, "test"), None, kwargs
