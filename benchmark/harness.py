"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in ``BENCHMARK.json``:

* ``benchmark/configs/<config>.json``: the configuration (source, sizes,
  run config, tree, classes, data set);
* ``benchmark/traffic/<traffic>.json``: the traffic mix, the parameters
  of the driver it names;
* ``benchmark/drivers/<driver>.py``: the generator of one kind of traffic
  (a ``Cell`` class: set-up, the timed window, the end-to-end metrics and
  the outputs the check compares);
* ``benchmark/workloads/<cell>.json``: the cell (its configuration, mix,
  chips, why, and the limits of its check);
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader
  (``read(ctx)``, None where it finds nothing) and the end-to-end metric
  it ``MOVES``.

A run sets the cell up (set-up ends when the window starts), measures for
``--seconds`` (under the profiler with ``--trace 1``), reads the peak
memory, takes the per-layer metrics, frees the program's state, runs the
reference and the comparison that decides ``correct``, and prints one JSON
line.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Mapping, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# whole top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "pipnet_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, package: str, name: str) -> ModuleType:
    """The Python file ``path`` as the module ``benchmark.<package>.<name>``
    (so that its relative imports resolve), found by path: file names may
    hold dots."""
    safe = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"benchmark.{package}.{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench: Mapping, bench_dir: str = BENCH_DIR) -> Dict:
    """The cell's entry in ``BENCHMARK.json`` with its files: the cell's
    own, its configuration's and its traffic mix's."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    w = dict(entries[name])
    cell = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if cell.get(key) != w[key]:
            raise ValueError(f"{name}: {key} is {w[key]!r} in BENCHMARK.json and "
                             f"{cell.get(key)!r} in its workload file")
    w["cell_file"] = cell
    w["config_file"] = load_json(os.path.join(bench_dir, "configs", f"{w['config']}.json"))
    w["mix"] = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    return w


def driver(spec: Mapping, bench_dir: str = BENCH_DIR) -> ModuleType:
    name = spec["mix"]["driver"]
    return load_module(os.path.join(bench_dir, "drivers", f"{name}.py"), "drivers", name)


def applies(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return load_module(os.path.join(bench_dir, "metrics", f"{name}.py"), "metrics", name)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name, power limit and clocks by ``nvidia-smi``, or why
    they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def run_cell(spec: Mapping, bench: Mapping, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, fault: Optional[str] = None,
             bench_dir: str = BENCH_DIR, marks: Optional[List] = None) -> Dict:
    """One run of the cell ``spec``: the result line's fields and the
    numbers the check compared (``checks``).  ``fault`` plants one of the
    driver's faults (the tests' and the calibration's).  ``marks``: the
    parts of set-up that the caller ended before, as (name, host time)."""
    import torch
    from . import judge, tracing
    name = spec["name"]
    drv = driver(spec, bench_dir)
    marks = list(marks or []) + [("port_import", time.perf_counter())]
    cell = drv.Cell(spec, seed, device, fault=fault)
    cell.marks = marks      # the driver appends the end of each part of its set-up
    cell.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("synchronise", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    prof = tracing.start() if trace else None
    w = cell.window(seconds)
    if prof is not None:
        prof.stop()
    w["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": int(spec["chips"]), "memory_peak_bytes": int(w["peak_bytes"])}
    result: Dict = {}
    if trace:
        ctx = SimpleNamespace(cell=cell, spec=spec, window=w, prof=prof,
                              trace=tracing.Trace(prof, w["window_s"]), seed=seed,
                              parts=functools.cache(cell.parts))
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, name):
                continue
            value = metric_reader(m["name"], bench_dir).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_rec.update(busy_s=ctx.trace.busy_s(), window_s=w["window_s"])
        result["breakdown"] = ctx.trace.breakdown()
    else:
        values = dict(cell.end_to_end(w))
        values["setup_s"] = (setup_s, "s")
        metrics = {}
        for m in bench["end_to_end"]:
            if applies(m, name):
                if m["name"] not in values:
                    raise KeyError(f"{name} reports no {m['name']}")
                v, unit = values[m["name"]]
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    summary = getattr(cell, "summary", lambda w: {})(w)
    attempted, failed = cell.attempted(w)
    cell.release()
    reference = cell.reference()
    numbers = cell.numbers(reference)
    v = judge.verdict(numbers, spec["cell_file"]["limits"])
    result.update(correct=v["correct"], attempted=attempted, failed=failed, metrics=metrics,
                  device=device_rec, checks=v["checks"], numbers=numbers)
    result["_summary"] = summary
    result["_setup"] = setup_parts(marks, t_start)
    return result


def setup_parts(marks, t_start: float) -> Dict[str, float]:
    """Seconds of set-up by part, from the host times that the harness and
    the driver marked at the end of each (``Cell.marks``)."""
    out, t = {}, t_start
    for label, at in marks:
        out[label] = round(at - t, 4)
        t = at
    return out


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark of "
                                 "pipnet_tpu_torch on one CUDA card and print one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    spec = cell_spec(args.workload, bench)
    import torch
    marks = [("python_and_torch_import", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
        print(f"benchmark: the cell needs {spec['chips']} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(spec, bench, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
                      marks=marks)
    leaked = forbidden_modules()
    if leaked:
        print(f"benchmark: the process loaded {leaked}: no result", file=sys.stderr)
        return 3
    # read after the run, so that nvidia-smi's time is no part of set-up
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    print(f"setup_s by part: {json.dumps(result.pop('_setup'))}", file=sys.stderr)
    summary = result.pop("_summary")
    if summary:
        print(f"window: {json.dumps(summary)}", file=sys.stderr)
    checks = result.pop("checks")
    for n, c in checks.items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
