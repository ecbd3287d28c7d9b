"""Time two of the port's paths on the GPU with the CSE pass off and on.

    python3 tools/torch_cse_ab.py [--pairs 10] [--seed 0]

The paths are ``chip_smoke.phase_main_path`` (int4 ``cram_matmul`` on
the attention projections of qwen2-0.5b's layer 0, 864 ``lane_fold``
launches) and ``chip_smoke.phase_fabric_layer`` (layer 0's linears at
W4A4 in fabric mode; its wall is the sum of its groups' walls, its
checks and profile excluded).  "Off" raises ``engine.CSE_MIN_CYCLES``
out of reach, so every program resolves ``cse=None`` to the eager
lowered function; "on" is the default.  Each mode runs each path once
untimed first, so both keep their own lowered functions and traced
graphs in the compile cache (raised so that nothing is evicted); then
``--pairs`` pairs run, the order alternating (off-on, on-off, ...).
Every run passes the phase's own exactness checks.  Prints one JSON
line per path (each mode's walls, median, min, max and ``lane_fold``
launches) and the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def set_cse(on: bool, default=engine.CSE_MIN_CYCLES):
    engine.CSE_MIN_CYCLES = default if on else 1 << 60


def main_path(rng, seed):
    launches, wall, _ = chip_smoke.phase_main_path(rng)
    return wall, launches


def fabric_layer(rng, seed):
    launches, groups = chip_smoke.phase_fabric_layer(seed)
    return sum(g["wall_s"] for g in groups.values()), launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cse_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    build.build_all()
    chip_smoke.emit = lambda obj: None  # the phases' own lines
    engine.set_compile_cache_limit(4096)
    rng = np.random.default_rng(args.seed)
    for name, path in (("main_path_int4", main_path),
                       ("fabric_qwen2_layer0", fabric_layer)):
        runs = {"off": [], "on": []}
        launches = {"off": set(), "on": set()}
        order = [("off", "on") if i % 2 == 0 else ("on", "off")
                 for i in range(args.pairs)]
        for i, pair in enumerate([("off", "on")] + order):
            for mode in pair:
                set_cse(mode == "on")
                wall, n = path(rng, args.seed)
                launches[mode].add(n)
                if i:                   # the first pair warms both modes
                    runs[mode].append(wall)
        set_cse(True)
        print(json.dumps({"path": name, "pairs": args.pairs, **{
            mode: {"walls_s": w, "median_s": statistics.median(w),
                   "min_s": min(w), "max_s": max(w),
                   "lane_fold_launches": sorted(launches[mode])}
            for mode, w in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
