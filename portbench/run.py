"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, driver, metrics and limits are
looked up by the names ``BENCHMARK.json`` gives them (``pb_harness``).
Set-up makes the inputs and weights from ``--seed`` on the card and warms
every shape the mix uses; the window then runs the mix's jobs back to
back for ``--seconds`` and finishes the one in flight.  With ``--trace
1`` the per-layer metrics' spans and counters are wrapped around the
program's callables and the window runs under ``torch.profiler``; with
``--trace 0`` nothing is wrapped.  Once the window has closed and the
peak memory is read, the program's state is freed and the plain
reference in ``reference/`` judges what the window produced.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number judged beside its
limit, also printed as the last lines of standard error).  Exits
non-zero, with no result, without enough CUDA devices, without the
program, or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

# caches of anything that compiles stay at fixed paths in the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(BENCH.parent / ".portbench_cache" / _dir)

import pb_harness as H  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, layout=None, device=None, t_start=None):
    """Run the cell; returns the exit code.  ``layout`` and ``device``
    are for the CPU rehearsals: a device given here skips the look for
    CUDA devices."""
    args = parse(argv)
    t_start = T_START if t_start is None else t_start
    layout = layout or H.Layout()
    cell = H.resolve_cell(layout, args.workload)
    import torch
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s), found "
                  f"{have}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda \
        else (lambda: None)
    ctx = SimpleNamespace(cfg=cell.config, mix=cell.traffic,
                          seed=args.seed, device=device, sync=sync,
                          model=H.model_config(cell.config),
                          limits=cell.limits)
    state = cell.driver.setup(ctx)
    sync()
    rec = SimpleNamespace(setup_s=time.perf_counter() - t_start,
                          seconds=args.seconds, spans={}, calls={},
                          trace=None, work={}, jobs=[])
    tracer = prof = None
    if args.trace:
        tracer = H.Tracer(sync)
        roots = cell.driver.roots(state)
        for _, mod in cell.per_layer:
            for t in getattr(mod, "SPANS", ()):
                if t not in tracer.spans:
                    tracer.span(t, roots)
            for t in getattr(mod, "CALLS", ()):
                if t not in tracer.calls:
                    tracer.record(t, roots)
        if on_cuda:
            prof = H.start_profiler()
        now = time.perf_counter_ns()
        clocks = {"realtime": time.time_ns() - now,
                  "monotonic": time.monotonic_ns() - now}
    try:
        cell.driver.window(state, args.seconds, rec)
    finally:
        if prof is not None:
            prof.stop()
        if tracer is not None:
            tracer.close()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    if tracer is not None:
        rec.spans.update(tracer.spans)
        rec.calls = tracer.calls
    if prof is not None:
        rec.trace = H.reduce_trace(prof, (rec.t0, rec.t1), clocks,
                                   rec.spans)
        del prof
    cell.driver.release(state)
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    verdict = cell.driver.check(state, rec)
    del state
    metrics = {}
    for m, mod in (cell.per_layer if args.trace else cell.end_to_end):
        v = mod.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    bad = H.forbidden_modules()
    if bad:
        print(f"modules the port must not load were loaded: {bad}",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda
           else "cpu", "count": cell.chips,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(verdict["correct"]),
           "attempted": int(verdict["attempted"]),
           "failed": int(verdict["failed"]), "metrics": metrics,
           "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.window_s
        out["breakdown"] = H.breakdown(rec.trace)
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in verdict["compared"].items()}
    for k, (v, lim) in verdict["compared"].items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
