"""Where the port builds its native code (the CUDA kernels, ``ops/build.py``,
and the normalizer, ``native/``).

In a checkout of the repository (the package beside ``pyproject.toml``, as
an editable install also leaves it) that is ``<checkout>/build``, listed in
``.gitignore``.  An installed package (a wheel in ``site-packages``, which
may be read-only and is shared by every environment user) builds into the
user's cache instead: ``$XDG_CACHE_HOME/pipnet_tpu_torch``, by default
``~/.cache/pipnet_tpu_torch``.  Either way a library's file name carries the
hash of its sources and flags, so two versions never load each other's.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent


def build_root(package_dir: Path = PACKAGE_DIR) -> Path:
    checkout = package_dir.parent
    if (checkout / "pyproject.toml").exists():
        return checkout / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "pipnet_tpu_torch"
