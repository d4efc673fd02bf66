"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``kernels/lib<name>-<hash>.so`` under the build
root (``paths.build_root``: ``build/`` in a checkout, listed in
``.gitignore``; the user's cache for an installed package) at first use,
and loaded with ``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

from ..paths import build_root

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = build_root() / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns seconds per kernel (0.0 when it
    was already built); raises with the compiler's output on a failure.
    ``--ptxas-options=-v`` (registers, shared memory, spills) goes to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)          # atomic: a reader never sees a partial .so
    return seconds


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built kernel library (built first if needed).  Every source
    exports ``pipnet_cuda_error_string`` for ``check_cuda``."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.pipnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pipnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_entry(name: str, symbol: str,
                 argtypes: Sequence) -> Tuple[ctypes.CDLL, Callable]:
    """The built library ``name`` and its C entry ``symbol``, with
    ``argtypes`` declared (``c_void_p`` for every pointer and the stream, so
    no pointer is cut to 32 bits) and the returned ``cudaError_t`` as an
    int."""
    lib = load_library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib, fn


def check_cuda(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel entry."""
    if code != 0:
        msg = lib.pipnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
