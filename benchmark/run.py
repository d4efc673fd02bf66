"""Run one cell of the benchmark of pipnet_tpu_torch on CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, their metrics and bounds are in
``BENCHMARK.json``; ``benchmark/harness.py`` says how a run goes.  A host
without the cards the cell asks for gets no result and a non-zero exit.
The port's kernels build into the checkout's ``build/`` (its own rule) and
Triton's cache goes to ``build/triton``, so only a checkout's first run
compiles.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
