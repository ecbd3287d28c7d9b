"""The port's span recorder (``repro_torch.trace``): off it records
nothing, on it records spans with their parents and tags and counters,
and the spans at the layer boundaries of the fabric and serve paths are
where their names say, without changing a result."""

import time

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core import engine, programs
from repro_torch.models.model import LM
from repro_torch.pim import fabric
from repro_torch.pim import linear as pl
from repro_torch.serve.engine import Request, ServeEngine, _bucket


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _names(spans):
    return [s[0] for s in spans]


def _children(spans, i):
    return [j for j, s in enumerate(spans) if s[3] == i]


@trace.spanned("decorated")
def _decorated(x):
    return x + 1


def test_off_records_nothing():
    assert trace.span("a", k=1) is trace.NULL
    with trace.span("a"):
        trace.count("c", 3)
    assert _decorated(1) == 2
    assert trace.take() == ([], {})


def test_on_records_parents_tags_and_counters():
    trace.enable()
    with trace.span("outer", rid=7):
        with trace.span("inner"):
            trace.count("c", 2)
        trace.count("c")
    with trace.span("next"):
        assert _decorated(1) == 2
    spans, counters = trace.take()
    assert _names(spans) == ["outer", "inner", "next", "decorated"]
    (_, a0, a1, ap, at), (_, b0, b1, bp, bt), (_, c0, c1, cp, _) = spans[:3]
    assert (ap, at) == (None, {"rid": 7}) and (bp, bt) == (0, {})
    assert cp is None and spans[3][3] == 2
    assert a0 <= b0 <= b1 <= a1 <= c0 <= c1
    assert counters == {"c": 3, "engine.compile_misses": 0}
    # take() cleared the record; recording goes on until disable()
    assert trace.take() == ([], {"engine.compile_misses": 0})
    with trace.span("x"):
        pass
    trace.disable()
    with trace.span("y"):
        pass
    assert _names(trace.take()[0]) == ["x"]


def _blocks_state(rng, blocks, rows=64, cols=8):
    return engine.CRState(
        torch.as_tensor(rng.integers(0, 2, (blocks, rows, cols)) > 0),
        torch.zeros((blocks, cols), dtype=torch.bool),
        torch.ones((blocks, cols), dtype=torch.bool))


def test_execute_blocks_with_a_cse_trace_is_bit_identical_on_and_off():
    prog, _ = programs.iadd(8, rows=64)
    st = _blocks_state(np.random.default_rng(3), 5)
    outs = []
    for on in (False, True):
        engine.clear_compile_cache()
        if on:
            trace.enable()
        outs.append(engine.execute_blocks(prog, st, cse=True))
        outs.append(engine.execute_blocks(prog, st, cse=True))
        trace.disable()
    for a, b in zip(outs[:2], outs[2:]):
        for f, g in zip(a, b):
            assert torch.equal(f, g)
    spans, counters = trace.take()
    # one compile (lowering and CSE trace) inside the first launch
    assert _names(spans) == ["engine.execute_blocks", "engine.compile",
                             "engine.execute_blocks"]
    assert spans[1][3] == 0 and spans[2][3] is None
    assert counters["engine.compile_misses"] == 1


def test_fabric_linear_records_each_launch_and_its_slots(monkeypatch):
    grid = fabric.FabricConfig(n_blocks=6, rows=128, cols=8)
    cfg = pl.PimConfig(mode="fabric", fabric=grid)
    gen = torch.Generator().manual_seed(0)
    ps = [pl.pack_linear(pl.linear_init(gen, 64, n, cfg, device="cpu"),
                         cfg) for n in (32, 7)]
    x = torch.randn((2, 64), generator=gen).to(torch.bfloat16)
    want = pl.fused_linear_apply(ps, x, cfg)
    launched = []
    run = engine.execute_blocks

    def counted(program, states, *a, **kw):
        launched.append(states.array.shape[0])
        return run(program, states, *a, **kw)

    monkeypatch.setattr(engine, "execute_blocks", counted)
    trace.enable()
    got = pl.fused_linear_apply(ps, x, cfg)
    spans, counters = trace.take()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))

    names = _names(spans)
    assert names[0] == "pim.fused_linear" and spans[0][3] is None
    assert [names[j] for j in _children(spans, 0)] == [
        "pim.quantize", "pim.unpack_weights", "fabric.fused_matmul",
        "pim.dequant"]
    fm = names.index("fabric.fused_matmul")
    assert [names[j] for j in _children(spans, fm)] == [
        "fabric.schedule", "fabric.encode", "fabric.execute",
        "fabric.unbias", "fabric.cost"]
    ex = names.index("fabric.execute")
    # the int class's operands go up once; each launch makes its slot
    # descriptor, uploads it and packs its images on the device
    per_launch = ["fabric.pack", "fabric.h2d", "fabric.pack",
                  "engine.execute_blocks", "fabric.d2h", "fabric.consume"]
    assert launched
    assert [names[j] for j in _children(spans, ex)] \
        == ["fabric.h2d"] + per_launch * len(launched)
    assert counters["fabric.packed_on_device"] == len(launched)
    assert "fabric.packed_on_host" not in counters
    assert counters["engine.blocks_launched"] \
        == sum(engine.canonical_block_budget(b) for b in launched)
    specs = tuple(fabric.GemmSpec(f"proj{g}", 2, 64, n)
                  for g, n in enumerate((32, 7)))
    sched = fabric.schedule_program(specs, 8, cfg=grid, signed=True)
    assert counters["fabric.slots_used"] \
        == sum(len(r.tasks) for r in sched.rounds)
    assert counters["fabric.slots_used"] <= sum(launched)


def test_serve_records_prefills_by_request_and_their_padding():
    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, batch_slots=2, capacity=32,
                      device="cpu")
    lens = (3, 5, 9, 16)
    for rid, n in enumerate(lens):
        eng.add(Request(rid=rid, prompt=(np.arange(n) * 7 + rid).astype(
            np.int32) % cfg.vocab, max_new=3))
    trace.enable()
    with torch.no_grad():
        done = eng.run()
    spans, counters = trace.take()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]

    names = _names(spans)
    prefills = [s for s in spans if s[0] == "serve.prefill"]
    assert sorted(s[4]["rid"] for s in prefills) == [0, 1, 2, 3]
    assert eng.stats["prefill_tokens"] == sum(lens)
    assert counters["serve.prefill_padded_tokens"] \
        == sum(_bucket(n) - n for n in lens)
    for i, s in enumerate(spans):
        if s[0] == "serve.prefill":
            assert names[s[3]] == "serve.admit"
            inner = [names[j] for j in _children(spans, i)]
            assert inner[0] == "model.embed" and inner[-1] == "serve.merge"
        if s[0] == "serve.decode":
            inner = [names[j] for j in _children(spans, i)]
            assert inner == ["model.embed"] + ["model.attention",
                                               "model.mlp"] \
                * cfg.n_layers + ["model.head", "serve.sample"]
        if s[0] in ("serve.admit", "serve.decode", "serve.retire",
                    "serve.kv_append"):
            assert names[s[3]] == "serve.step"
    assert names.count("serve.decode") \
        == eng.stats["decode_warm_steps"] + 1


def test_annotations_match_spans_on_the_profilers_clock():
    """Each span has its ``record_function`` range, and their starts
    agree once the realtime offset (as ``reduce_trace`` samples it) is
    applied: the median gap is under 1 ms (a median, so that a thread
    descheduled between the two stamps on a loaded host cannot fail
    it)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((64, 64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        now = time.perf_counter_ns()
        offset = time.time_ns() - now
        trace.enable(annotate=True)
        for i in range(20):
            with trace.span("probe.outer"):
                with trace.span("probe.inner"):
                    x = x @ x / 64
        trace.disable()
    spans, _ = trace.take()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")
              and e.device_type() == torch.autograd.DeviceType.CPU]
    for name in ("probe.outer", "probe.inner"):
        starts = sorted(e.start_ns() for e in events if e.name() == name)
        mine = sorted(s[1] + offset for s in spans if s[0] == name)
        assert len(starts) == len(mine) == 20
        gaps = sorted(abs(a - b) for a, b in zip(starts, mine))
        assert gaps[len(gaps) // 2] < 1_000_000
