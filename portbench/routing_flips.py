"""Whether a latent-attention MoE cell's served-token gaps come from the
router picking other experts than the float32 reference picks.

    python3 portbench/routing_flips.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

Runs the cell's window as ``run.py`` does and takes the check's sample
of finished requests (``driver.sample``).  Each is replayed at batch 1
through the port (``LM.prefill`` over the prompt padded to its bucket as
the engine pads it, then ``LM.decode_step`` over the served tokens, the
absorbed decode), and the float32 reference
(``reference/deepseek_v2.py``) runs over the same tokens; both record
the top-k experts of every MoE layer at every position.  A position's
routing differs where some layer's top-k set does.

Per position of a served token (the one after which it was chosen): the
served gap (the check's number, of the token the engine served), the
replay's gap (of the token the replay puts first) and the replay's
logit error (largest absolute difference from the reference over the
vocabulary), and the layers whose routing differs.  The line summarises
them for positions whose routing differs and for those where it does
not, separately for the prefill's last position and the decoded ones,
and lists the served positions with the widest gaps.  The replay runs a
second time with the reference's experts forced into the router's place
(``forced_error``): what is left is the rounding of the rest, the
attention among it, so a fault of the absorbed decode shows there as a
gap between the decoded positions and the prefill's last.  The replay at
batch 1 stands in for the engine's batched steps: the engine's routing
is not recorded, so ``replay_agrees`` gives the share of positions
whose first token the replay and the engine agree on.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import pb_harness as H  # noqa: E402


class _TopkLog:
    """``torch`` for the reference's module, logging ``topk``'s indices."""

    def __init__(self, torch, log):
        self._torch, self._log = torch, log

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def topk(self, *args, **kwargs):
        out = self._torch.topk(*args, **kwargs)
        self._log.append(out.indices)
        return out


def _sets(idx):
    return idx.sort(-1).values


def _summary(values) -> dict:
    if not values:
        return {"n": 0}
    return {"n": len(values), "median": statistics.median(values),
            "max": max(values)}


def _port(st, padded, served, s, force, torch):
    """The port's replay: logits ``(n, vocab)`` of the positions after
    which the ``n`` served tokens were chosen, and its top-k there ``(L,
    n, k)``.  ``force`` (``(L, s + n, k)``, the reference's top-k) puts
    those experts in the router's place at every real position, with
    their probabilities as gates."""
    from repro_torch.models import moe

    mc, dev, model, w = st.ctx.model, st.ctx.device, st.model, st.params
    n, layers = served.numel(), st.ctx.model.n_layers - mc.first_k_dense
    log, real_gates = [], moe._gates

    def gates(probs, spec):
        gate, idx = real_gates(probs, spec)
        if force is not None:
            layer, step = len(log) % layers, len(log) // layers
            idx = idx.clone()
            if step == 0:                       # the prefill's real rows
                idx[:s] = force[layer, :s]
            else:                               # one decoded position
                idx[0] = force[layer, s + step - 1]
            gate = probs.gather(-1, idx)
            if getattr(spec, "norm_topk_prob", True):
                gate = gate / gate.sum(-1, keepdim=True)
            gate = gate * getattr(spec, "routed_scaling_factor", 1.0)
        log.append(idx)
        return gate, idx

    moe._gates = gates
    try:
        with torch.no_grad():
            logits, caches = model.prefill(
                w, tokens=padded[None], capacity=st.ctx.mix["capacity"])
            got = [logits[0, s - 1:s]]
            for i in range(n - 1):
                step, caches = model.decode_step(
                    w, caches, served[None, i:i + 1],
                    torch.tensor([s + i], dtype=torch.int32, device=dev))
                got.append(step[0])
        del caches, logits
    finally:
        moe._gates = real_gates
    pre = torch.stack(log[:layers])[:, s - 1:s]                # (L, 1, k)
    dec = [torch.stack(log[layers * (1 + i):layers * (2 + i)])
           for i in range(n - 1)]                               # (L, 1, k)
    return torch.cat(got).float(), _sets(torch.cat([pre] + dec, 1))


def replay(st, req, ref, torch):
    """Per served token: served gap, replay gap, replay error, layers
    whose top-k differs, whether the replay's first token is the served
    one, and the replay's error with the reference's experts forced."""
    mc, dev, w = st.ctx.model, st.ctx.device, st.params
    prompt = torch.as_tensor(req.prompt, dtype=torch.int32, device=dev)
    served = torch.as_tensor(req.out, dtype=torch.int32, device=dev)
    s, n = prompt.numel(), served.numel()
    ref_idx = []
    real_torch = ref.torch
    ref.torch = _TopkLog(real_torch, ref_idx)
    try:
        want = ref.forward(w, mc, torch.cat([prompt, served]))
    finally:
        ref.torch = real_torch
    ref_idx = torch.stack(ref_idx)                             # (L, S, k)
    # the prompt padded to its power-of-two bucket, as the engine pads it
    padded = torch.zeros((min(1 << (s - 1).bit_length(),
                              st.ctx.mix["capacity"]),),
                         dtype=torch.int32, device=dev)
    padded[:s] = prompt
    got, port = _port(st, padded, served, s, None, torch)
    forced, _ = _port(st, padded, served, s, ref_idx, torch)
    at = want[s - 1:s - 1 + n]
    mine = _sets(ref_idx[:, s - 1:s - 1 + n])
    differs = (port != mine).any(-1).sum(0).tolist()         # (n,)
    best = at.max(-1).values
    gap = (best - at.gather(1, served.long()[:, None])[:, 0]).tolist()
    first = got.argmax(-1)
    rgap = (best - at.gather(1, first[:, None])[:, 0]).tolist()
    err = (got - at).abs().amax(-1).tolist()
    agree = (first == served.long()).tolist()
    ferr = (forced - at).abs().amax(-1).tolist()
    return list(zip(gap, rgap, err, differs, agree, ferr))


def main(argv=None, layout=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--widest", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from reference import deepseek_v2 as ref

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
    st.engine = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rows = []
    for req in reqs:
        for i, r in enumerate(replay(st, req, ref, torch)):
            rows.append((req.rid, i) + r)
    out = {"workload": cell.name, "seed": args.seed, "requests": len(reqs),
           "positions": len(rows),
           "replay_agrees": sum(r[6] for r in rows) / max(len(rows), 1),
           "routing_differs": sum(1 for r in rows if r[5]),
           "layers_differing": _summary([r[5] for r in rows if r[5]])}
    for part, keep in (("prefill_last", lambda r: r[1] == 0),
                       ("decoded", lambda r: r[1] > 0)):
        for label, flip in (("differs", True), ("same", False)):
            sel = [r for r in rows if keep(r) and bool(r[5]) == flip]
            out[f"{part}.{label}"] = {
                "served_gap": _summary([r[2] for r in sel]),
                "replay_gap": _summary([r[3] for r in sel]),
                "replay_error": _summary([r[4] for r in sel]),
                "forced_error": _summary([r[7] for r in sel])}
    out["widest"] = [
        {"rid": r[0], "token": r[1], "served_gap": r[2], "replay_gap": r[3],
         "replay_error": r[4], "forced_error": r[7],
         "layers_differing": r[5]}
        for r in sorted(rows, key=lambda r: -r[2])[:args.widest]]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
