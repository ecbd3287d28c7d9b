"""One window of a cell with the program's own recorder on.

    python3 portbench/program_trace.py --workload <name> --seed <n> \
        --seconds <s> [--clock] [--out <file.json>]

Sets the cell up as ``run.py`` does and runs its window with
``repro_torch.trace`` on.  No harness wrapper is installed, so nothing
synchronises the device that the program does not.

By default the window runs under the harness's own profiler
(``pb_harness.start_profiler``, CUDA activity, on a CUDA device), the
recorder without ``record_function`` ranges.  The recorder's spans,
with the driver's own, label the idle gaps in ``pb_harness.reduce_trace``;
the line gives each reading of ``pb_program.READERS`` for the cell's
driver (with ``fabric.rest_share``, the jobs' wall outside every fabric
phase and launch), the share of the idle seconds a program span labels,
the device's busy seconds, the breakdown, and the driver's verdict on
the window's outputs.

With ``--clock`` the window runs under a profiler of CPU (and CUDA)
activity with ``annotate=True``: every span is then also a
``record_function`` range on the profiler's clock.  The spans are mapped
onto that clock by the offset ``reduce_trace`` chooses from the clocks
sampled as ``run.py`` samples them, each name's spans are paired in
order with its ranges, and the line summarises the gaps between the
pairs' starts (range start less mapped span start): their count,
median, 99th percentile and extremes, also by span name.

Prints one JSON line, and writes it to ``--out`` where given.
"""

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import pb_harness as H  # noqa: E402
import pb_program  # noqa: E402


def summary(gaps_ns) -> dict:
    g = sorted(gaps_ns)
    return {"n": len(g), "median_us": statistics.median(g) / 1e3,
            "p99_us": g[int(0.99 * (len(g) - 1))] / 1e3,
            "min_us": g[0] / 1e3, "max_us": g[-1] / 1e3}


def clock_gaps(prof, by_name, off) -> dict:
    """Range start less mapped span start, over each name's pairs."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name() in by_name:
            ranges.setdefault(e.name(), []).append(e.start_ns())
    gaps, names = [], {}
    for name, ss in by_name.items():
        mine = sorted(int(a * 1e9) + off for a, _ in ss)
        theirs = sorted(ranges.get(name, ()))
        g = [b - a for a, b in zip(mine, theirs)]
        gaps += g
        names[name] = {"spans": len(mine), "ranges": len(theirs),
                       "median_us": statistics.median(g) / 1e3
                       if g else None}
    return {"spans": sum(len(ss) for ss in by_name.values()),
            "ranges": sum(len(r) for r in ranges.values()),
            "gap": summary(gaps) if gaps else None, "by_name": names}


def main(argv=None, layout=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--clock", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace

    cell = H.resolve_cell(layout or H.Layout(), args.workload)
    device = torch.device(device or "cuda")
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda \
        else (lambda: None)
    ctx = SimpleNamespace(cfg=cell.config, mix=cell.traffic,
                          seed=args.seed, device=device, sync=sync,
                          model=H.model_config(cell.config),
                          limits=cell.limits)
    state = cell.driver.setup(ctx)
    sync()
    rec = SimpleNamespace(seconds=args.seconds, spans={}, calls={},
                          trace=None, work={}, jobs=[])
    roots = cell.driver.roots(state)
    stats0 = {n: dict(o.stats) for n, o in roots.items()
              if isinstance(getattr(o, "stats", None), dict)}
    prof = None
    if args.clock:
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_cuda else []))
        prof.start()
    elif on_cuda:
        prof = H.start_profiler()
    now = time.perf_counter_ns()
    clocks = {"realtime": time.time_ns() - now,
              "monotonic": time.monotonic_ns() - now}
    trace.enable(annotate=args.clock)
    try:
        cell.driver.window(state, args.seconds, rec)
    finally:
        trace.disable()
        if prof is not None:
            prof.stop()
    spans, rec.counters = trace.take()
    for n, before in stats0.items():
        for k, v in roots[n].stats.items():
            if isinstance(v, int) and isinstance(before.get(k, 0), int):
                rec.counters[f"@{n}:{k}"] = v - before.get(k, 0)
    mine = {}
    for name, t0, t1, _, _ in spans:
        if t1 is not None:
            mine.setdefault(name, []).append((t0 / 1e9, t1 / 1e9))
    rec.spans.update(mine)
    out = {"workload": cell.name, "seed": args.seed,
           "window_s": rec.t1 - rec.t0, "clock_mode": args.clock}
    if prof is not None:
        tr = H.reduce_trace(prof, (rec.t0, rec.t1), clocks, rec.spans)
        out["clock"] = tr["clock"]
        if args.clock:
            out.update(clock_gaps(prof, mine, clocks[tr["clock"]]))
        else:
            out["busy_s"] = tr["busy_s"]
            out["idle_labelled_pct"] = pb_program.labelled_share(
                tr["idle_by_span"])
            out["breakdown"] = H.breakdown(tr)
        del prof
    if not args.clock:
        readers = pb_program.READERS.get(cell.traffic["driver"], {})
        got = {k: f(rec) for k, f in readers.items()}
        out["readings"] = {k: v for k, v in got.items() if v is not None}
        if cell.traffic["driver"] == "fabric" and out["readings"]:
            out["readings"]["fabric.rest_share"] = 100 - sum(
                v for k, v in out["readings"].items()
                if k.endswith("_share") and k != "fabric.pad_share")
        out["counters"] = rec.counters
    cell.driver.release(state)
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    verdict = cell.driver.check(state, rec)
    out["correct"] = bool(verdict["correct"])
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
