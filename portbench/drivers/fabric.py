"""Driver of the fabric cells: a stream of PIM-linear jobs through the
simulated Compute RAM fabric.

Each job is one ``repro_torch.pim.linear.fused_linear_apply`` call with
``PimConfig(mode="fabric")`` at the mix's weight and activation bits on
the default grid: the linears of one group of a model layer (they share
their input and run as one fused fabric program) on ``rows`` seeded bf16
activation rows.  The stream walks the groups of layer 0, then layer 1,
..., and starts over after the last layer; the window ends at the end of
a layer (the layer in flight is finished).  Set-up makes every layer's
bf16 weights and every job's activations on the device from the seed,
packs the weights (the program's offline weight preparation) and runs
the group of fewest MACs once: every group's launches replay the one
round program that call compiles, so the window finds it built (the
engine's compile-cache misses in the window are printed to standard
error; they are 0).

The mix (``traffic/<mix>.json``): ``weight_bits``, ``act_bits``,
``rows``, and ``groups``: ``[[group, [linear, ...]], ...]`` with linears
named ``q k v o gate up down`` (widths from the configuration).
"""

from __future__ import annotations

import sys
import time

import torch

from reference import fabric as ref


def linear_shapes(mc) -> dict:
    """(K, N) of each linear of one layer of the model config ``mc``."""
    d, hq, hkv, f = mc.d_model, mc.n_heads * mc.hd, mc.n_kv_heads * mc.hd, \
        mc.d_ff
    return {"q": (d, hq), "k": (d, hkv), "v": (d, hkv), "o": (hq, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}


class State:
    pass


def setup(ctx):
    from repro_torch.pim import linear as pl

    mix, mc, dev = ctx.mix, ctx.model, ctx.device
    st = State()
    st.ctx = ctx
    st.pim = pl.PimConfig(mode="fabric", weight_bits=mix["weight_bits"],
                          act_bits=mix["act_bits"])
    st.groups = [(g, list(names)) for g, names in mix["groups"]]
    st.layers = mc.n_layers
    shapes = linear_shapes(mc)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    # one draw per linear (all layers) and per group's inputs (all
    # layers): bf16, as served
    st.w = {}
    for _, names in st.groups:
        for n in names:
            k, o = shapes[n]
            st.w[n] = (torch.randn((st.layers, k, o), generator=gen,
                                   device=dev) * k ** -0.5).to(torch.bfloat16)
    st.x = {g: torch.randn((st.layers, mix["rows"], shapes[names[0]][0]),
                           generator=gen, device=dev).to(torch.bfloat16)
            for g, names in st.groups}
    st.params = [{n: pl.pack_linear({"w": st.w[n][layer]}, st.pim)
                  for _, names in st.groups for n in names}
                 for layer in range(st.layers)]
    st.macs = {g: mix["rows"] * shapes[names[0]][0]
               * sum(shapes[n][1] for n in names) for g, names in st.groups}
    # every job replays one compiled round program on 512-block
    # launches; the group of fewest MACs compiles (and CSE-traces) it
    g, names = min(st.groups, key=lambda gn: st.macs[gn[0]])
    pl.fused_linear_apply([st.params[0][n] for n in names], st.x[g][0],
                          st.pim)
    ctx.sync()
    st.outs = []
    return st


def roots(st) -> dict:
    return {}


def job(st, j):
    """(layer, group index) of the stream's ``j``-th job."""
    ng = len(st.groups)
    return (j // ng) % st.layers, j % ng


def window(st, seconds, rec):
    from repro_torch.pim import linear as pl

    from repro_torch.core import engine

    sync = st.ctx.sync
    jobs, spans = [], {}
    misses = engine.compile_cache_stats()["misses"]
    t0 = time.perf_counter()
    end = t0 + seconds
    j = 0
    ng = len(st.groups)
    # whole layers: the groups' MAC rates differ several-fold, so a
    # window that stopped between groups would swing with where it stopped
    while not jobs or j % ng or time.perf_counter() < end:
        layer, gi = job(st, j)
        g, names = st.groups[gi]
        ts = time.perf_counter()
        outs = pl.fused_linear_apply([st.params[layer][n] for n in names],
                                     st.x[g][layer], st.pim)
        sync()
        te = time.perf_counter()
        st.outs.append(outs)
        jobs.append({"layer": layer, "group": g, "t0": ts, "t1": te,
                     "macs": st.macs[g]})
        spans.setdefault(f"job {g}", []).append((ts, te))
        j += 1
    print(f"compiles in the window: "
          f"{engine.compile_cache_stats()['misses'] - misses}",
          file=sys.stderr)
    rec.t0, rec.t1 = t0, jobs[-1]["t1"]
    rec.window_s = rec.t1 - t0
    rec.jobs = jobs
    rec.spans.update(spans)
    rec.work = {"macs": sum(x["macs"] for x in jobs),
                "jobs_per_layer": len(st.groups)}


def release(st):
    """Free the program's state; keep the window's outputs and the
    inputs of its jobs on the host for the check."""
    st.outs = [[y.to("cpu") for y in outs] for outs in st.outs]
    st.params = None
    st.w = {n: w.to("cpu") for n, w in st.w.items()}
    st.x = {g: x.to("cpu") for g, x in st.x.items()}


def _judge(st, rec, outputs_of):
    wb, ab = st.pim.weight_bits, st.pim.act_bits
    bad_elems = bad_jobs = 0
    for j, (jb, outs) in enumerate(zip(rec.jobs, st.outs)):
        layer, gi = job(st, j)
        g, names = st.groups[gi]
        x = st.x[g][layer]
        got = outputs_of(j, outs, x, names, layer)
        n_bad = sum(ref.mismatches(y, ref.linear(x, st.w[n][layer], wb, ab))
                    for n, y in zip(names, got))
        bad_elems += n_bad
        bad_jobs += n_bad > 0
    return bad_elems, bad_jobs


def check(st, rec, control=False):
    """Every job's outputs against the reference, bit for bit.  With
    ``control`` the reference's lower-precision control
    (``reference.fabric.control``, on the cell's device) stands in for
    the program's outputs, on the window's jobs and under the same
    limit."""
    limit = st.ctx.limits["mismatched_outputs"]
    wb, ab = st.pim.weight_bits, st.pim.act_bits
    dev = st.ctx.device

    def program(j, outs, x, names, layer):
        return outs

    def ctl(j, outs, x, names, layer):
        return [ref.control(x.to(dev), st.w[n][layer].to(dev), wb, ab)
                for n in names]

    bad, bad_jobs = _judge(st, rec, ctl if control else program)
    return {"correct": bool(rec.jobs) and bad <= limit,
            "attempted": len(rec.jobs), "failed": bad_jobs,
            "compared": {"mismatched_outputs": (bad, limit)}}


def control(st, rec):
    """``check``'s verdict with the control in the program's place."""
    return check(st, rec, control=True)
