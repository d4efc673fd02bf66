"""The port stands alone: importing every module of ``pipnet_tpu_torch``
loads neither JAX nor the JAX package, and no source of the port (nor
``chip_smoke.py``) imports them."""

import os
import re
import subprocess
import sys

from torch_port_util import REPO

_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|flax|optax|pipnet_tpu(?!_torch))\b",
                     re.MULTILINE)


def test_importing_the_port_loads_no_jax():
    """... and starts no process: no module builds its native library or a
    kernel when imported (``native`` runs g++, ``ops.build`` nvcc, at first
    use)."""
    code = (
        "import importlib, pkgutil, subprocess, sys\n"
        "def refuse(*a, **k): raise AssertionError(f'a process started at import: {a}')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import pipnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pipnet_tpu_torch.__path__, "
        "'pipnet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pipnet_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 64, names\n"
        "for m in ('ops.fused_head_nopf', 'ops.dwconv', 'ops.cnblock', 'losses.catalog', "
        "'losses.aggregate', 'train.optimizer', 'train.step', 'data.loader', "
        "'data.device_cache', 'ops.device_augment', 'ops.device_geometric', 'native', "
        "'datasets', 'runtime.log', 'runtime.profiling', 'train.checkpoint', "
        "'train.trainer', 'main', 'paths', 'eval', 'eval.metrics', 'evaluate', 'interp', "
        "'interp.adversarial', 'interp.heatmaps', 'interp.hierarchy_viz', 'interp.mips', "
        "'interp.part_purity', 'interp.patches', 'interp.prediction', 'interp.pruning', "
        "'interp.topk', 'models.resnet', 'models.vit', 'models.byol', "
        "'models.torch_import', 'models.torch_export'):\n"
        "    assert 'pipnet_tpu_torch.' + m in names, m\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_import_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "pipnet_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hits = _IMPORT.findall(f.read())
        assert not hits, (path, hits)
