"""A serve cell's closed loop kept running for several windows in one
process, as an endpoint that serves for hours runs.

    python3 portbench/soak.py --workload <serve cell> --seed <n> \
        --seconds <s> --windows <k> [--out <file.jsonl>]

Sets the cell up as ``run.py`` does, then drives one engine with the
mix's clients for ``k`` back-to-back windows of ``s`` seconds, with no
pause between them and request ids that run on across them (the
driver's own window starts its ids at 0, so it is not run twice on one
engine here).  After each window one JSON line: the tokens a second;
the median and 90th percentile of the steps that admitted nothing (a
pure decode step; the step ends with the sampled tokens on the host, so
its wall holds its device work); the prefills; the caching allocator's
allocated, reserved and peak bytes, its retries and its device
allocations and frees in the window; the process's resident memory;
and the card's SM clock, temperature and power (``nvidia-smi``, read
only).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import pb_harness as H  # noqa: E402

ALLOC_KEYS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def card_state() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
             "power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10).stdout.strip()
        sm, temp, power = (float(v) for v in out.split("\n")[0].split(","))
        return {"sm_mhz": sm, "temp_c": temp, "power_w": power}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {}


def rss_bytes() -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return 0


def main(argv=None, layout=None, device=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.serve.engine import Request

    cell = H.resolve_cell(layout or H.Layout(), args.workload)
    device = torch.device(device or "cuda")
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda \
        else (lambda: None)
    ctx = SimpleNamespace(cfg=cell.config, mix=cell.traffic,
                          seed=args.seed, device=device, sync=sync,
                          model=H.model_config(cell.config),
                          limits=cell.limits)
    st = cell.driver.setup(ctx)
    sync()
    eng, mix = st.engine, cell.traffic
    sent = []

    def send():
        prompt, max_new = st.requests[len(sent) % len(st.requests)]
        req = Request(rid=len(sent), prompt=prompt, max_new=max_new)
        sent.append(req)
        eng.add(req)

    def alloc():
        if not on_cuda:
            return {}
        s = torch.cuda.memory_stats(device)
        return {k: s.get(k, 0) for k in ALLOC_KEYS}

    for _ in range(mix["clients"]):
        send()
    lines = []
    with torch.no_grad():
        for w in range(args.windows):
            if on_cuda:
                torch.cuda.reset_peak_memory_stats(device)
            a0, admitted0 = alloc(), eng.stats["admitted"]
            produced0 = sum(len(r.out) for r in sent)
            decode_ms, t0 = [], time.perf_counter()
            end = t0 + args.seconds
            while time.perf_counter() < end:
                before, s0 = eng.stats["admitted"], time.perf_counter()
                finished = eng.step()
                if eng.stats["admitted"] == before:
                    decode_ms.append((time.perf_counter() - s0) * 1e3)
                for _ in finished:
                    send()
            t1 = time.perf_counter()
            a1 = alloc()
            line = {"workload": cell.name, "seed": args.seed, "window": w,
                    "tok_per_s": (sum(len(r.out) for r in sent)
                                  - produced0) / (t1 - t0),
                    "decode_steps": len(decode_ms),
                    "decode_ms_median": statistics.median(decode_ms)
                    if decode_ms else None,
                    "decode_ms_p90": statistics.quantiles(
                        decode_ms, n=10)[-1] if len(decode_ms) > 1
                    else None,
                    "prefills": eng.stats["admitted"] - admitted0,
                    "queued": len(eng.queue), "rss_bytes": rss_bytes()}
            if on_cuda:
                line.update(
                    allocated_bytes=torch.cuda.memory_allocated(device),
                    reserved_bytes=torch.cuda.memory_reserved(device),
                    peak_bytes=torch.cuda.max_memory_allocated(device),
                    **{k: a1[k] - a0[k] for k in ALLOC_KEYS},
                    **card_state())
            lines.append(line)
            print(json.dumps(line), flush=True)
    cell.driver.release(st)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return lines


if __name__ == "__main__":
    main()
