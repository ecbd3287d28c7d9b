"""Driver of the serve cells: ``repro_torch.serve.engine.ServeEngine``
under a closed loop of clients.

Set-up makes the model's weights on the device from the seed
(``pb_weights``), builds the engine with the mix's slots, capacity, page
size and admission, and warms every prefill bucket the mix's prompts
reach and the decode step.  The window starts with every client sending
its first request; a client sends its next request as soon as its last
one is done, in the order of the mix's request sequence
(``pb_traffic.requests``).  Greedy decoding.

A token's time is the end of the engine step that produced it (the first
token's is the engine's own stamp at its prefill).

The mix (``traffic/<mix>.json``): ``slots``, ``capacity``,
``page_size``, ``admission``, ``clients``, ``pool`` (requests in the
sequence), ``prompt`` and ``output`` (lognormal length specs), and
``check``: ``min_tokens`` (served tokens the check samples at least).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import pb_peaks
import pb_traffic
import pb_weights
from reference import lm as ref


#: the reading when no finished request could be checked (it fails)
NOTHING_CHECKED = 1e9


class State:
    pass


def buckets(mix) -> list:
    """The prefill shapes the mix's prompts reach (powers of two, capped
    at the capacity), as the engine pads them."""
    lo = 1 << max(0, int(mix["prompt"]["min"] - 1).bit_length())
    hi = min(1 << int(mix["prompt"]["max"] - 1).bit_length(),
             mix["capacity"])
    out, b = [], lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out


def setup(ctx):
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import ServeEngine

    mix, mc, dev = ctx.mix, ctx.model, ctx.device
    st = State()
    st.ctx = ctx
    st.params = pb_weights.lm_weights(mc, ctx.seed, dev)
    st.model = LM(mc, device=dev)
    st.engine = ServeEngine(st.model, st.params, batch_slots=mix["slots"],
                            capacity=mix["capacity"],
                            page_size=mix["page_size"],
                            admission=mix["admission"], device=dev)
    st.requests = pb_traffic.requests(mix, ctx.seed, mc.vocab)
    eng = st.engine
    with torch.no_grad():
        for b in buckets(mix):
            eng._prefill_one(st.params,
                             torch.zeros((1, b), dtype=torch.int32,
                                         device=dev))
        logits, _ = eng._decode(st.params, eng.caches,
                                torch.zeros((mix["slots"], 1),
                                            dtype=torch.int32, device=dev),
                                torch.zeros((mix["slots"],),
                                            dtype=torch.int32, device=dev))
        torch.argmax(logits[:, 0], dim=-1).cpu()
    ctx.sync()
    return st


def roots(st) -> dict:
    return {"engine": st.engine}


def window(st, seconds, rec):
    from repro_torch.serve.engine import Request

    eng, mix = st.engine, st.ctx.mix
    sent, seen, times = [], {}, {}
    occupancy = []

    def send():
        prompt, max_new = st.requests[len(sent) % len(st.requests)]
        req = Request(rid=len(sent), prompt=prompt, max_new=max_new)
        sent.append(req)
        times[req.rid] = []
        eng.add(req)

    t0 = time.perf_counter()
    end = t0 + seconds
    for _ in range(mix["clients"]):
        send()
    steps = 0
    t_last = t0
    with torch.no_grad():
        while steps == 0 or time.perf_counter() < end:
            finished = eng.step()
            t_last = time.perf_counter()
            steps += 1
            live = [r for r in eng.slots if r is not None]
            occupancy.append(len(live) / eng.B)
            for req in live + finished:
                n, k = len(req.out), seen.get(req.rid, 0)
                for i in range(k, n):
                    times[req.rid].append(req.t_first if i == 0 else t_last)
                seen[req.rid] = n
            for _ in finished:
                send()
    rec.t0, rec.t1 = t0, t_last
    rec.window_s = t_last - t0
    rec.jobs = sent
    gaps = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])]
    mc = st.ctx.model
    flops = 0
    for req in sent:
        n = seen.get(req.rid, 0)
        if req.t_admit is None:
            continue
        s = len(req.prompt)
        # the prompt's tokens, then each decoded token over its context
        flops += sum(pb_peaks.lm_matmul_flops(mc)
                     + pb_peaks.attention_flops(mc, i + 1)
                     for i in list(range(s)) + list(range(s, s + n - 1)))
    rec.work = {"tokens": sum(seen.values()), "itl_s": gaps,
                "steps": steps, "occupancy": occupancy, "flops": flops,
                "done": [r for r in sent if r.done],
                "rejected": len(eng.rejected)}


def release(st):
    st.engine = st.model = st.params = None


def sample(st, rec) -> list:
    """The finished requests the check reads: the longest (prompt and
    served tokens), then others in an order drawn from the seed, until
    ``check.min_tokens`` served tokens are covered."""
    done = rec.work["done"]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.out), r.rid))
    rest = [r for r in done if r is not longest]
    order = pb_traffic.rng(st.ctx.seed, 4).permutation(len(rest))
    out, n = [longest], len(longest.out)
    for i in order:
        if n >= st.ctx.mix["check"]["min_tokens"]:
            break
        out.append(rest[i])
        n += len(rest[i].out)
    return out


def _gaps(st, rec, quant=None):
    """Per sampled request, the float32 reference's gap of each served
    token (``quant``: the gap of the token the control puts first)."""
    mc, dev = st.ctx.model, st.ctx.device
    w = pb_weights.lm_weights(mc, st.ctx.seed, dev)
    out = []
    for req in sample(st, rec):
        seq = torch.as_tensor(np.concatenate(
            [np.asarray(req.prompt), np.asarray(req.out, np.int32)]))
        logits = ref.forward(w, mc, seq)
        s = len(req.prompt)
        if quant is None:
            out.append(ref.served_gaps(logits, s, req.out))
        else:
            ctl = ref.forward(w, mc, seq, quant=quant)
            first = ctl[s - 1:s - 1 + len(req.out)].argmax(-1).tolist()
            out.append(ref.served_gaps(logits, s, first))
            del ctl
        del logits
    return out


def check(st, rec, quant=None):
    """The widest gap by which a served token's logit lies below the
    float32 reference's best, over a seeded sample of the window's
    finished requests with the longest among them.  With ``quant``
    (``"fp8"``) the control stands in for the engine: at each position
    of the same prompts and served tokens, the token that the reference
    in that precision puts first is judged, under the same limit."""
    limit = st.ctx.limits["served_logit_gap"]
    gaps = _gaps(st, rec, quant)
    widest = max((max(g) for g in gaps if g), default=NOTHING_CHECKED)
    return {"correct": bool(gaps) and widest <= limit,
            "attempted": len(rec.jobs),
            "failed": rec.work["rejected"]
            + sum(1 for g in gaps if g and max(g) > limit),
            "compared": {"served_logit_gap": (widest, limit)}}


def control(st, rec):
    """``check``'s verdict with the fp8 control in the engine's place."""
    return check(st, rec, quant="fp8")
