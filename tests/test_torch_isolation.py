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
    code = (
        "import importlib, pkgutil, sys\n"
        "import pipnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pipnet_tpu_torch.__path__, "
        "'pipnet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pipnet_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
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
