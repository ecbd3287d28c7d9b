"""Readings that a cell's limits are set from: the program's compared
numbers over many seeds, and the lower-precision control's on the same
windows, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control]

For each seed: the cell's set-up and a window of ``--seconds`` as
``run.py`` makes them, then the driver's ``check`` (the program's
reading) and, with ``--control``, the driver's ``control``: the same
check with the reference in the nearest precision below the stated one
in the program's place, and its verdict (``control_correct``, which has
to be false).  One JSON line a seed, then the largest program
reading and the smallest control reading of each number.  The
benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402,F401  (sets the path and the cache directories)
import pb_harness as H  # noqa: E402


def readings(cell, seeds, seconds, control=False, device=None):
    """One dict a seed: the program's compared numbers and verdict, and
    with ``control`` the control's, each from its own set-up and window
    of ``seconds``."""
    import torch
    device = torch.device(device or "cuda")
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda \
        else (lambda: None)
    for seed in seeds:
        ctx = SimpleNamespace(cfg=cell.config, mix=cell.traffic, seed=seed,
                              device=device, sync=sync,
                              model=H.model_config(cell.config),
                              limits=cell.limits)
        t0 = time.perf_counter()
        st = cell.driver.setup(ctx)
        rec = SimpleNamespace(setup_s=time.perf_counter() - t0,
                              seconds=seconds, spans={}, calls={},
                              trace=None, work={}, jobs=[])
        cell.driver.window(st, seconds, rec)
        cell.driver.release(st)
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        got = cell.driver.check(st, rec)
        line = {"seed": seed, "attempted": len(rec.jobs),
                "window_s": rec.window_s,
                "program": {k: v for k, (v, _) in got["compared"].items()},
                "program_correct": got["correct"]}
        if control:
            ctl = cell.driver.control(st, rec)
            line["control"] = {k: v for k, (v, _) in
                               ctl["compared"].items()}
            line["control_correct"] = ctl["correct"]
        yield line
        del st, rec
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()


def main(argv=None, layout=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = H.resolve_cell(layout or H.Layout(), args.workload)
    program, control = {}, {}
    for line in readings(cell, [int(s) for s in args.seeds.split(",")],
                         args.seconds, args.control, device):
        for k, v in line["program"].items():
            program[k] = max(program.get(k, v), v)
        for k, v in line.get("control", {}).items():
            control[k] = min(control.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "program_max": program,
                      "control_min": control,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
