"""Readings that set a cell's limits: the program against the reference on
many seeds, the control (the reference in the precision below the
configuration's) and the planted faults against the reference on a few.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 1,2,3] [--faults half_batch:1,2,3] [--out chiprun_out/x.jsonl]

runs them all in one process on the card (each seed's reference once),
printing one JSON line per reading: ``{"seed", "what", "numbers"}``.  The
benchmark's own runs never run this.  ``--logit-std`` instead prints, for
each seed, the standard deviation of the add-on logits F K of the
configuration's reference model over 64 seeded images, the reading that
sets a configuration's ``add_on_scale``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness, judge  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(spec, seed, device, control, faults, window_s, bands=(), lowers=("float8",)):
    """The reading of the program, the control and each fault for one
    seed, against one reference (for a serving cell, at each threshold
    band of ``bands`` too)."""
    drv = harness.driver(spec)
    serve = drv.Cell.kind == "serve"
    cell = drv.Cell(spec, seed, device)
    cell.setup()
    cell.window(window_s)
    cell.release()
    ref = cell.reference()
    out = [("program", cell.numbers(ref))]
    if not serve:
        out.append(("program/diagnostics", judge.train_diagnostics(cell.checked, ref)))
    low = None
    for precision in lowers if control else ():
        tag = f"control[{precision}]"
        if serve:
            low = cell.answers(precision)
            out.append((tag, cell.numbers(cell.reference(served=low), served=low)))
        else:
            low = cell.reference(precision)
            out.append((tag, judge.train_numbers(low, ref)))
            out.append((tag + "/diagnostics", judge.train_diagnostics(low, ref)))
    for band in bands:
        out.append((f"program@band={band}", cell.numbers(cell.reference(band=band))))
        if low is not None:
            out.append((f"control[{lowers[-1]}]@band={band}",
                        cell.numbers(cell.reference(served=low, band=band), served=low)))
    for fault in faults:
        bad = drv.Cell(spec, seed, device, fault=fault)
        bad.setup()
        bad.window(window_s)
        bad.release()
        out.append((fault, bad.numbers(ref if not serve else bad.reference())))
    return out


def logit_std(spec, seed, device):
    import torch
    from benchmark import seeded
    from benchmark.reference.model import build, merged_run_config, run_config, state_shapes
    d = merged_run_config(spec["config_file"], spec["mix"].get("changes"))
    cfg = run_config(d, "float32")
    shapes, tree = state_shapes(spec["config_file"], cfg)
    weights = seeded.seeded_state_dict(shapes, tree, seed, device, 1.0)
    model, _ = build(spec["config_file"], cfg, weights, device)
    xs = seeded.normalised_images(64, cfg.model.image_size, seed, device)
    with torch.inference_mode():
        f = model.features(xs)
        return (f @ model.head.add_on_kernel).std().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control", type=_seeds, default=[])
    ap.add_argument("--faults", default="", help="fault:seed,seed;fault:seed,...")
    ap.add_argument("--window", type=float, default=2.0,
                    help="seconds of window before the check (serving answers what it checks)")
    ap.add_argument("--bands", default="", help="threshold bands to read a serving cell at")
    ap.add_argument("--lowers", default="float8", help="the controls' precisions (float8,int8)")
    ap.add_argument("--logit-std", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload, harness.manifest())
    faults = {}
    for part in filter(None, args.faults.split(";")):
        name, seeds = part.split(":")
        for s in _seeds(seeds):
            faults.setdefault(s, []).append(name)
    out = open(args.out, "a") if args.out else None
    for seed in sorted(set(args.seeds) | set(args.control) | set(faults)):
        t = time.perf_counter()
        if args.logit_std:
            rows = [("logit_std", logit_std(spec, seed, "cuda"))]
        else:
            rows = readings(spec, seed, "cuda", seed in args.control, faults.get(seed, []),
                            args.window, [float(b) for b in args.bands.split(",") if b],
                            args.lowers.split(","))
        for what, numbers in rows:
            if what == "program" and seed not in args.seeds:
                continue
            line = json.dumps({"workload": args.workload, "seed": seed, "what": what,
                               "numbers": numbers, "s": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
