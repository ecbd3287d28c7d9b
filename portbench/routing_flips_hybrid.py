"""Whether a hybrid (Jamba) MoE cell's served-token gaps come from the
router picking other experts than the float32 reference picks, read on
the experts the timed path itself routed to.

    python3 portbench/routing_flips_hybrid.py --workload <cell> \
        --seed <n> --seconds <s> [--out <file.json>]

Runs the cell's window as ``run.py`` does (``drivers/serve_hybrid.py``
records the experts of every position it served) and takes the check's
sample of finished requests (``driver.sample``).  The float32 reference
(``reference/jamba.py``) runs over each request's prompt and served
tokens twice: on its own (``free``: the gap the serve driver's check
reads, the reference choosing its own experts) and along the served
experts (``forced``: the gap the hybrid driver's check reads), where it
also gives each position's route margin in each MoE layer (how far the
weakest served expert lay below its own top-k, in router logits; 0
where it would choose the same).

Per position of a served token (the one after which it was chosen): the
free and forced gaps and forced logit difference from the free run
(largest over the vocabulary), the MoE layers that routed there
otherwise than the reference would, and the widest margin.  The line
summarises them for positions routed otherwise and for the others,
separately for the prefill's last position and the decoded ones, counts
the rerouted decisions over every position of the sample (prompts
included), and lists the served positions with the widest free gaps.
"""

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import pb_harness as H  # noqa: E402
import routing_flips as rf  # noqa: E402


def replay(st, rec, req, w, torch):
    """Per served token: free gap, forced gap, the forced run's largest
    logit difference from the free one, the layers routed otherwise and
    their widest margin; and the sample's rerouted decisions and widest
    margin over every routed position."""
    import numpy as np
    from reference import jamba as ref

    mc = st.ctx.model
    seq = torch.as_tensor(np.concatenate(
        [np.asarray(req.prompt), np.asarray(req.out, np.int32)]))
    s, n = len(req.prompt), len(req.out)
    free = ref.forward(w, mc, seq)
    got = {}
    forced = ref.forward(w, mc, seq, routes=rec.work["routes"][req.rid],
                         record=got)
    margin = torch.stack(got["margin"])[:, :s + n - 1]      # (L, s+n-1)
    at = slice(s - 1, s - 1 + n)
    rows = list(zip(ref.served_gaps(free, s, req.out),
                    ref.served_gaps(forced, s, req.out),
                    (forced[at] - free[at]).abs().amax(-1).tolist(),
                    (margin[:, at] > 0).sum(0).tolist(),
                    margin[:, at].amax(0).tolist()))
    return rows, int((margin > 0).sum()), margin.numel(), \
        float(margin.max())


def main(argv=None, layout=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--widest", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    cell = H.resolve_cell(layout or H.Layout(), args.workload)
    device = torch.device(device or "cuda")
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    ctx = SimpleNamespace(cfg=cell.config, mix=cell.traffic,
                          seed=args.seed, device=device, sync=sync,
                          model=H.model_config(cell.config),
                          limits=cell.limits)
    st = cell.driver.setup(ctx)
    rec = SimpleNamespace(seconds=args.seconds, spans={}, calls={},
                          trace=None, work={}, jobs=[])
    cell.driver.window(st, args.seconds, rec)
    reqs = cell.driver.sample(st, rec)
    w = st.params
    cell.driver.release(st)
    rows, rerouted, decisions, widest_margin = [], 0, 0, 0.0
    for req in reqs:
        got, k, m, top = replay(st, rec, req, w, torch)
        rows += [(req.rid, i) + r for i, r in enumerate(got)]
        rerouted, decisions = rerouted + k, decisions + m
        widest_margin = max(widest_margin, top)
    out = _summarise(cell.name, args.seed, len(reqs), rows, args.widest)
    out.update(rerouted_decisions=rerouted, routed_decisions=decisions,
               route_logit_margin=widest_margin)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


def _summarise(name, seed, n_reqs, rows, widest) -> dict:
    out = {"workload": name, "seed": seed, "requests": n_reqs,
           "positions": len(rows),
           "routing_differs": sum(1 for r in rows if r[5]),
           "layers_differing": rf._summary([r[5] for r in rows if r[5]])}
    for part, keep in (("prefill_last", lambda r: r[1] == 0),
                       ("decoded", lambda r: r[1] > 0)):
        for label, flip in (("differs", True), ("same", False)):
            sel = [r for r in rows if keep(r) and bool(r[5]) == flip]
            out[f"{part}.{label}"] = {
                "free_gap": rf._summary([r[2] for r in sel]),
                "forced_gap": rf._summary([r[3] for r in sel]),
                "forced_shift": rf._summary([r[4] for r in sel]),
                "margin": rf._summary([r[6] for r in sel])}
    out["widest"] = [
        {"rid": r[0], "token": r[1], "free_gap": r[2], "forced_gap": r[3],
         "forced_shift": r[4], "layers_differing": r[5], "margin": r[6]}
        for r in sorted(rows, key=lambda r: -r[2])[:widest]]
    return out


if __name__ == "__main__":
    main()
