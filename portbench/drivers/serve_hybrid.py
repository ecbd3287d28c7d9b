"""Driver of the serve cells of a Jamba hybrid (Mamba-1 mixers beside GQA
attention without positions, dense and routed FFNs): the serve driver
(``drivers/serve.py``) as it is, loaded as a module of its own, with this
model's weights (``pb_jamba.weights``), FLOPs (``pb_jamba.token_flops``,
``attention_flops``) and plain reference (``reference/jamba.py``) in
place of the dense LM's.  The engine prefills such a stack at each
prompt's exact length (its recurrent state would fold pads in), so the
shapes the set-up warms (``buckets``) are the pool's distinct prompt
lengths, not powers of two.

Every window records in ``rec.work["ssm_mixer"]`` what
``ssm.prefill_roofline`` needs of the model: a Mamba mixer's matmul
FLOPs a token, its weights' bytes and the bytes of a token's input and
output row.  In a traced run (``run.py --trace 1`` wraps
``moe.moe_apply`` for ``moe.decode_share``) the window also runs with
the port's recorder on (``repro_torch.trace``), and after it the MoE's
device counters are read once into ``rec.work["device_counters"]``, the
host counters into ``rec.work["counters"]``, and ``rec.work
["moe_decode"]`` gives what ``moe.byte_roofline`` needs: the bytes of
one expert, of one routed row, and the rows of one decode call.  So, as
in the latent-attention MoE cell, this cell's traced per-layer metrics
are taken with the recorder on.  ``release`` empties the engine before
the serve driver's release drops it (a traced run keeps the engine named
as a span root until its end).

The check judges what the timed path served along the experts it
routed to.  The window records, without a synchronisation, the experts
of every router call (``moe._gates``) and which request each call's rows
belong to (a prefill's request, a decode step's lanes), so each served
request has the experts of each of its positions in each MoE layer
(``rec.work["routes"]``).  The float32 reference then runs along those
experts (``reference/jamba.py``'s ``routes``), and the check reads two
numbers: ``served_logit_gap``, as the serve driver's but against that
reference, and ``route_logit_margin``, the widest margin by which a
routed expert lay below the reference's own top-k there, over every
position of the sampled requests.  A router's near tie in bf16 picks
another expert than the float32 reference; in this 16-layer stack of
random weights the one swap moves later logits by up to about 2, as
far as the fp8 control's whole error, so the served gap alone cannot
tell the two apart.  Along the served experts the gap reads only the
rest of the arithmetic, and the margin holds the router to near ties.
The control stands in for the engine in both: its own experts (the
reference in fp8) are the ones judged, and its first token at each
position.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import pb_jamba
import pb_traffic
from reference import jamba


def prompt_lengths(mix) -> list:
    """The prefill shapes the mix reaches on a stack prefilled at exact
    lengths: the pool's distinct prompt lengths (the same for every
    seed, which only reorders them)."""
    return sorted({int(n) for n in pb_traffic.length_pool(mix["prompt"],
                                                          mix["pool"])})


def _serve_driver():
    path = Path(__file__).with_name("serve.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_serve_for_hybrid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pb_weights = SimpleNamespace(lm_weights=pb_jamba.weights)
    mod.pb_peaks = SimpleNamespace(
        lm_matmul_flops=pb_jamba.token_flops,
        attention_flops=pb_jamba.attention_flops)
    mod.ref = jamba
    mod.buckets = prompt_lengths
    return mod


serve = _serve_driver()
buckets, setup, roots = serve.buckets, serve.setup, serve.roots
sample = serve.sample


def release(st):
    """The serve driver's release, after emptying the engine: ``run.py``
    keeps the span roots of a traced run (``roots(st)``: the engine)
    until the run ends, so the engine would hold its weights and caches
    through the check, and this model's 52 GB of weights do not fit on
    the card twice."""
    if st.engine is not None:
        vars(st.engine).clear()
    serve.release(st)


def traced() -> bool:
    """Whether ``run.py`` wrapped the MoE for a traced run."""
    from repro_torch.models import moe
    return hasattr(moe.moe_apply, "__wrapped__")


class _Routes:
    """The experts of every router call while installed, and whose rows
    they were: ``("prefill", rid, calls)`` for a request's prefill,
    ``("decode", [(lane, rid), ...], calls)`` for a decode step."""

    def __init__(self, eng):
        from repro_torch.models import moe
        self.eng, self.moe, self.events, self.log = eng, moe, [], []
        self.real = (moe._gates, eng._prefill_into, eng._decode)

    def __enter__(self):
        eng, log, events = self.eng, self.log, self.events
        real_gates, prefill_into, decode = self.real

        def gates(probs, spec):
            gate, idx = real_gates(probs, spec)
            log.append(idx)
            return gate, idx

        def prefill(i, req):
            prefill_into(i, req)
            events.append(("prefill", req.rid, log[:]))
            log.clear()

        def step(*a, **kw):
            lanes = [(i, r.rid) for i, r in enumerate(eng.slots)
                     if r is not None]
            out = decode(*a, **kw)
            events.append(("decode", lanes, log[:]))
            log.clear()
            return out

        self.moe._gates = gates
        eng._prefill_into, eng._decode = prefill, step
        return self

    def __exit__(self, *exc):
        self.moe._gates = self.real[0]
        del self.eng._prefill_into          # the class's method again
        self.eng._decode = self.real[2]

    def by_request(self, layers: int, rids) -> dict:
        """rid (of ``rids``) -> per MoE layer the ``(positions, top_k)``
        experts of the request's positions in order (a prefill starts
        them anew: a resumed request prefills its prompt and output
        again)."""
        parts, rids = {}, set(rids)
        for kind, who, calls in self.events:
            if len(calls) != layers:
                raise RuntimeError(f"a {kind} routed {len(calls)} times "
                                   f"through {layers} MoE layers")
            if kind == "prefill":
                if who in rids:
                    parts[who] = [[c] for c in calls]
                continue
            for lane, rid in who:
                if rid in rids:
                    for got, c in zip(parts[rid], calls):
                        got.append(c[lane:lane + 1])
        return {rid: [torch.cat(p) for p in ps]
                for rid, ps in parts.items()}


def window(st, seconds, rec):
    from repro_torch import trace
    mc = st.ctx.model
    routes = _Routes(st.engine)
    with routes:
        if not traced():
            serve.window(st, seconds, rec)
        else:
            trace.enable()
            try:
                serve.window(st, seconds, rec)
            finally:
                rec.work["device_counters"] = trace.device_counters()
                rec.work["counters"] = trace.take()[1]
                trace.disable()
    if traced():
        rec.work["moe_decode"] = {
            "expert_bytes": pb_jamba.expert_bytes(mc),
            "row_bytes": mc.d_model * pb_jamba.BF16,
            "rows_per_call": st.engine.B * mc.moe.top_k}
    rec.work["routes"] = routes.by_request(
        sum(mc.moe_at(i) for i in range(mc.n_layers)),
        [r.rid for r in rec.work["done"]])
    rec.work["ssm_mixer"] = {
        "flops_per_token": pb_jamba.mixer_flops(mc, 1),
        "weight_bytes": pb_jamba.mixer_weight_bytes(mc),
        "row_bytes": 2 * mc.d_model * pb_jamba.BF16}


def _readings(st, rec, quant=None):
    """Per sampled request: the float32 reference's gap of each served
    token and the widest route margin, along the experts the window
    routed its positions to (``quant``: the control's first tokens,
    along the experts the reference in that precision routes to)."""
    mc, dev = st.ctx.model, st.ctx.device
    w = pb_jamba.weights(mc, st.ctx.seed, dev)
    routes = rec.work["routes"]
    out = []
    for req in sample(st, rec):
        seq = torch.as_tensor(np.concatenate(
            [np.asarray(req.prompt), np.asarray(req.out, np.int32)]))
        s, n = len(req.prompt), len(req.out)
        if quant is None:
            used, served = routes[req.rid], req.out
            if used[0].shape[0] != s + n - 1:
                raise RuntimeError(
                    f"request {req.rid}: {used[0].shape[0]} routed "
                    f"positions, {s + n - 1} served")
        else:
            got = {}
            ctl = jamba.forward(w, mc, seq, quant=quant, record=got)
            used = got["routes"]
            served = ctl[s - 1:s - 1 + n].argmax(-1).tolist()
            del ctl, got
        got = {}
        logits = jamba.forward(w, mc, seq, routes=used, record=got)
        out.append((jamba.served_gaps(logits, s, served),
                    max(float(m[:s + n - 1].max())
                        for m in got["margin"])))
        del logits, got
    return out


def check(st, rec, quant=None):
    """The widest served-token gap and route margin over a seeded
    sample of the window's finished requests with the longest among them
    (``serve.sample``), each against its limit.  With ``quant``
    (``"fp8"``) the control stands in for the engine."""
    lim = st.ctx.limits
    got = _readings(st, rec, quant)
    gap = max((max(g) for g, _ in got if g), default=serve.NOTHING_CHECKED)
    margin = max((m for _, m in got), default=serve.NOTHING_CHECKED)
    return {"correct": bool(got) and gap <= lim["served_logit_gap"]
            and margin <= lim["route_logit_margin"],
            "attempted": len(rec.jobs),
            "failed": rec.work["rejected"] + sum(
                1 for g, m in got
                if (g and max(g) > lim["served_logit_gap"])
                or m > lim["route_logit_margin"]),
            "compared": {
                "served_logit_gap": (gap, lim["served_logit_gap"]),
                "route_logit_margin": (margin,
                                       lim["route_logit_margin"])}}


def control(st, rec):
    """``check``'s verdict with the fp8 control in the engine's place."""
    return check(st, rec, quant="fp8")
