"""The port's serve engine against the JAX package's, on the CPU.

The counterparts of ``tests/test_serve_engine.py`` and
``tests/test_serve_edge.py``: the same stub models, in torch (logits a
pure function of the input token and its position), and the same
requests through ``repro_torch.serve.ServeEngine``.  Wherever a test
produces token chains, the JAX engine serves the same requests with the
reference's stubs and the two engines' chains and integer counters must
be equal.  Then the LM legs of ``tests/test_pim_serve.py`` on the port
alone (engine against a manual greedy decode), the port's seeded
sampling, and a CPU rehearsal of ``chip_smoke``'s serve phase.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import test_serve_edge as ref_edge  # noqa: E402
import test_serve_engine as ref_se  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.faults import FaultModel  # noqa: E402
from repro_torch.kernels import bitplane_ops as bp  # noqa: E402
from repro_torch.models.convert import init_numpy  # noqa: E402
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.qweight import quantize_tree, tree_leaves  # noqa
from repro_torch.pim.fabric import FabricConfig, FabricLinearProbe  # noqa
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, _bucket  # noqa
from repro_torch.serve.kv import PagedKV  # noqa: E402
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig  # noqa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

VOCAB = 32
_chain = ref_se._chain


class _CountModel:
    """``test_serve_engine._CountModel`` in torch: next-token logits =
    one-hot of ``(7*t + 3 + 2*pos) % vocab``."""

    prefill_pad_safe = True

    def __init__(self, vocab=VOCAB, d=8):
        self.vocab = vocab
        self.embed = torch.from_numpy(np.random.default_rng(0).normal(
            size=(vocab, d)).astype(np.float32))

    def init_cache(self, b, cap):
        return {"n": torch.zeros((b,), dtype=torch.int32)}

    def _embed(self, params, tokens):
        return self.embed[tokens.long()]

    def _logits(self, tokens, pos):
        return F.one_hot(((7 * tokens + 3 + 2 * pos) % self.vocab).long(),
                         self.vocab).float()

    def prefill(self, params, tokens, capacity=None):
        b, s = tokens.shape
        posn = torch.arange(s, dtype=torch.int32)[None, :]
        return self._logits(tokens, posn), {
            "n": torch.full((b,), s, dtype=torch.int32)}

    def decode_step(self, params, caches, tokens, pos):
        return self._logits(tokens, pos[:, None]), caches


class _EchoModel(_CountModel):
    """``test_serve_edge._EchoModel`` in torch: one-hot of
    ``(7*t + 3) % vocab``, whatever the position."""

    def __init__(self, vocab=VOCAB, d=16):
        super().__init__(vocab, d)

    def _logits(self, tokens, pos):
        return super()._logits(tokens, 0 * pos)

    def prefill(self, params, tokens, capacity=None):
        return self._logits(tokens, 0), {
            "n": torch.zeros((1,), dtype=torch.int32)}


_STUBS = {"count": (_CountModel, ref_se._CountModel, 32),
          "echo": (_EchoModel, ref_edge._EchoModel, 16)}


def _engine(stub="count", **kw):
    model = _STUBS[stub][0]()
    if kw.pop("pad_unsafe", False):
        model.prefill_pad_safe = False
    return ServeEngine(model, params={}, batch_slots=kw.pop("B", 2),
                       capacity=kw.pop("capacity", _STUBS[stub][2]),
                       device="cpu", **kw)


def _ref_engine(stub="count", **kw):
    model = _STUBS[stub][1]()
    pad_unsafe = kw.pop("pad_unsafe", False)
    eng = ref_engine.ServeEngine(model, params={},
                                 batch_slots=kw.pop("B", 2),
                                 capacity=kw.pop("capacity",
                                                 _STUBS[stub][2]), **kw)
    if pad_unsafe:
        eng._pad_safe = False
    return eng


def _req(rid, plen, max_new=2, cls=Request, **kw):
    prompt = ((np.arange(plen) * 5 + rid) % VOCAB).astype(np.int32)
    return cls(rid=rid, prompt=prompt, max_new=max_new, **kw)


#: the port's decode steps by path (``_DecodeGraph``); the reference has
#: one path
_PATH_COUNTERS = ("decode_graph_replays", "decode_eager")


def _counters(eng):
    return {k: v for k, v in eng.stats.items()
            if isinstance(v, int) and k not in _PATH_COUNTERS}


def _serve_both(specs, stub="count", **kw):
    """Serve the requests ``specs`` (``(rid, prompt, kwargs)``) through
    the port's engine and the JAX engine; their finished requests, token
    chains, rejections and integer counters must be equal.  Returns the
    port's engine and finished requests."""
    eng, ref = _engine(stub, **dict(kw)), _ref_engine(stub, **dict(kw))
    for e, cls in ((eng, Request), (ref, ref_engine.Request)):
        for rid, prompt, rkw in specs:
            e.add(cls(rid=rid, prompt=np.asarray(prompt, np.int32), **rkw))
    done, want = eng.run(), ref.run()
    assert [(r.rid, r.out, r.preemptions) for r in done] \
        == [(r.rid, r.out, r.preemptions) for r in want]
    assert [r.rid for r in eng.rejected] == [r.rid for r in ref.rejected]
    assert _counters(eng) == _counters(ref)
    # on the host every decode step is eager
    assert eng.stats["decode_eager"] == eng._decode_count
    assert eng.stats["decode_graph_replays"] == 0
    return eng, done


def _spec(rid, plen, max_new=2, **kw):
    return rid, ((np.arange(plen) * 5 + rid) % VOCAB), dict(max_new=max_new,
                                                            **kw)


# ---------------------------------------------------------------------------
# PagedKV and the scheduler (copies of the reference's modules)
# ---------------------------------------------------------------------------
def test_kv_pages_for_and_capacity():
    kv = PagedKV(num_pages=4, page_size=4)
    assert [kv.pages_for(n) for n in (1, 4, 5, 8, 9)] == [1, 1, 2, 2, 3]
    assert kv.capacity_tokens == 16
    assert kv.can_ever_fit(16) and not kv.can_ever_fit(17)


def test_kv_alloc_append_free_lifecycle():
    kv = PagedKV(num_pages=3, page_size=4)
    assert kv.alloc(0, 4) and kv.free_pages == 2
    assert kv.append(0) and kv.used_pages == 2
    assert kv.alloc(1, 3) and kv.free_pages == 0
    assert kv.append(1) and kv.used_pages == 3
    assert not kv.append(1)
    assert kv.lens[1] == 4 and kv.stats["failed_appends"] == 1
    assert kv.free(0) == 2
    assert kv.append(1)
    kv.free(1)
    kv.assert_empty()
    assert kv.stats["allocs"] == kv.stats["frees"] == 2


def test_kv_failed_alloc_leaves_state_clean():
    kv = PagedKV(num_pages=2, page_size=4)
    assert kv.alloc(7, 8)
    assert not kv.alloc(8, 1)
    assert 8 not in kv.tables and kv.free_pages == 0
    with pytest.raises(KeyError):
        kv.alloc(7, 1)
    kv.free(7)
    kv.assert_empty()


def test_kv_leak_is_loud():
    kv = PagedKV(num_pages=2, page_size=4)
    kv.alloc(3, 4)
    with pytest.raises(AssertionError, match="leaked"):
        kv.assert_empty()


def test_deadline_scheduler_victim_is_latest_deadline():
    kv = PagedKV(num_pages=8, page_size=4)
    sched = Scheduler(SchedulerConfig(admission="deadline"), kv, 64)
    a = _req(0, plen=2, deadline_ms=10.0)
    b = _req(1, plen=2, deadline_ms=900.0)
    c = _req(2, plen=2)
    for seq, r in enumerate((a, b, c)):
        r._admit_seq = seq
    assert sched.pick_victim([a, b, c]) is c
    assert sched.pick_victim([a, b]) is b
    assert sched.pick_victim([a, b], protect=b) is a


# ---------------------------------------------------------------------------
# Admission: long prompts, rejection, truncation
# ---------------------------------------------------------------------------
def test_prompt_longer_than_capacity_is_rejected_not_crashed():
    eng, done = _serve_both([_spec(0, 17, 1)], B=1, capacity=16)
    assert done == [] and eng.stats["rejected"] == 1
    assert eng.rejected[0].status == "rejected" and eng.rejected[0].out == []
    eng.kv.assert_empty()


def test_prompt_plus_budget_beyond_capacity_is_rejected():
    eng, done = _serve_both([_spec(0, 12, 8)], B=1, capacity=16)
    assert done == [] and eng.stats["rejected"] == 1
    eng, done = _serve_both([_spec(1, 12, 4)], B=1, capacity=16)
    assert len(done) == 1 and len(done[0].out) == 4


def test_rejected_requests_do_not_block_the_queue():
    eng, done = _serve_both([_spec(0, 17, 1), _spec(1, 4, 2)], B=1,
                            capacity=16)
    assert [r.rid for r in done] == [1]
    assert done[0].out == _chain(done[0].prompt, 2)


def test_long_prompt_truncate_policy():
    rid, prompt, kw = _spec(0, 20, 2)
    eng, done = _serve_both([(rid, prompt, kw)], B=1, capacity=16,
                            long_prompt="truncate")
    assert len(done) == 1 and done[0].truncated
    assert eng.stats["truncated"] == 1 and eng.stats["rejected"] == 0
    assert len(done[0].prompt) == 16 - 2
    assert done[0].out == _chain(prompt[:14], 2)


# ---------------------------------------------------------------------------
# Backfill, accounting, the probe's lanes
# ---------------------------------------------------------------------------
def test_freed_slot_serves_in_the_same_step():
    eng = _engine(B=2)
    for rid in range(6):
        eng.add(_req(rid, plen=2, max_new=2))
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        if eng.queue:
            assert sum(s is not None for s in eng.slots) == eng.B
    assert eng.stats["admitted"] == 6


def test_backfill_keeps_fifo_order_and_chains():
    eng, done = _serve_both([_spec(rid, 3) for rid in range(5)], B=2)
    assert [r.rid for r in done] == [0, 1, 2, 3, 4]
    assert all(r.out == _chain(r.prompt, 2) for r in done)


def test_admit_only_step_counts_accounting():
    eng = _engine(B=1, step_deadline_ms=0.0)
    eng.add(_req(0, plen=4, max_new=1))
    done = eng.step()
    assert len(done) == 1 and done[0].out == _chain(done[0].prompt, 1)
    assert eng.stats["steps"] == 1 and eng.stats["deadline_misses"] == 1
    assert eng._step_count == 1


def test_idle_step_still_counts_nothing():
    eng = _engine(B=1)
    assert eng.step() == []
    assert eng.stats["steps"] == 0 and eng._step_count == 0


def test_probe_observes_only_active_lanes():
    probe = ref_se._ShapeProbe()
    eng = _engine(B=4, fabric_probe=probe)
    eng.add(_req(0, plen=2, max_new=3))
    eng.add(_req(1, plen=2, max_new=3))
    eng.run()
    assert probe.shapes and all(s[0] == 2 for s in probe.shapes)


def test_probe_lane_count_tracks_retirement():
    probe = ref_se._ShapeProbe()
    eng = _engine(B=2, fabric_probe=probe)
    eng.add(_req(0, plen=2, max_new=4))
    eng.add(_req(1, plen=2, max_new=2))
    eng.run()
    ms = [s[0] for s in probe.shapes]
    assert ms[0] == 2 and ms[-1] == 1


def test_no_leaked_pages_after_run():
    eng, done = _serve_both([_spec(rid, 3 + rid % 5, 1 + rid % 3)
                             for rid in range(7)],
                            B=2, capacity=16, page_size=4)
    assert len(done) == 7
    eng.kv.assert_empty()
    rep = eng.kv_report()
    assert rep["allocs"] == rep["frees"] == 7
    assert rep["pages_alloc"] == rep["pages_freed"]
    assert rep["high_water_pages"] <= rep["num_pages"]


# ---------------------------------------------------------------------------
# Preemption + resume
# ---------------------------------------------------------------------------
_PREEMPT = dict(B=2, capacity=16, page_size=4, num_pages=4)


def test_preemption_resume_token_bit_identity():
    eng, done = _serve_both([_spec(0, 4, 8), _spec(1, 4, 8)], **_PREEMPT)
    assert eng.stats["preemptions"] >= 1 and eng.stats["resumes"] >= 1
    assert all(r.out == _chain(r.prompt, 8) for r in done)
    assert any(r.preemptions for r in done)
    eng.kv.assert_empty()


def test_preemption_victim_is_last_admitted():
    _, done = _serve_both([_spec(0, 4, 8), _spec(1, 4, 8)], **_PREEMPT)
    by_rid = {r.rid: r for r in done}
    assert by_rid[1].preemptions >= 1 and by_rid[0].preemptions == 0


def test_unpreempted_run_matches_roomy_pool():
    eng, done = _serve_both([_spec(0, 4, 8), _spec(1, 4, 8)],
                            **{**_PREEMPT, "num_pages": 8})
    assert eng.stats["preemptions"] == 0
    assert all(r.out == _chain(r.prompt, 8) for r in done)


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------
def test_chunked_prefill_token_identity():
    whole, dw = _serve_both([_spec(0, 12, 4)], B=1)
    chunked, dc = _serve_both([_spec(0, 12, 4)], B=1, prefill_chunk=4)
    assert dw[0].out == dc[0].out == _chain(dw[0].prompt, 4)
    assert chunked.stats["stream_prefill_tokens"] == 8
    assert whole.stats["stream_prefill_tokens"] == 0


def test_chunked_prefill_interleaves_with_decode():
    eng = _engine(B=2, prefill_chunk=2)
    long_req, short_req = _req(0, plen=10, max_new=2), _req(1, plen=2,
                                                          max_new=8)
    eng.add(long_req)
    eng.add(short_req)
    eng.step()
    while long_req.status == "prefill":
        before = len(short_req.out)
        eng.step()
        if short_req.status != "done":
            assert len(short_req.out) == before + 1
    eng.run()
    assert long_req.out == _chain(long_req.prompt, 2)
    assert short_req.out == _chain(short_req.prompt, 8)
    _serve_both([_spec(0, 10, 2), _spec(1, 2, 8)], B=2, prefill_chunk=2)


def test_chunked_prefill_pages_grow_with_the_stream():
    eng = _engine(B=1, capacity=32, page_size=4, prefill_chunk=4)
    req = _req(0, plen=12, max_new=2)
    eng.add(req)
    eng.step()
    assert eng.kv.lens[0] == 5 and eng.kv.used_pages == 2
    growth = [eng.kv.used_pages]
    while not req.done:
        eng.step()
        if eng.kv.held(0):
            growth.append(eng.kv.used_pages)
    assert growth == sorted(growth)
    assert eng.kv.stats["high_water_pages"] == eng.kv.pages_for(13)
    eng.kv.assert_empty()


# ---------------------------------------------------------------------------
# Deadlines and latency
# ---------------------------------------------------------------------------
def test_deadline_admission_orders_by_slo():
    _, done = _serve_both([_spec(0, 2), _spec(1, 2, deadline_ms=500.0),
                           _spec(2, 2, deadline_ms=10.0)],
                          B=1, admission="deadline")
    assert [r.rid for r in done] == [2, 1, 0]


def test_fifo_admission_ignores_deadlines():
    _, done = _serve_both([_spec(0, 2), _spec(1, 2, deadline_ms=1.0)],
                          B=1, admission="fifo")
    assert [r.rid for r in done] == [0, 1]


def test_request_timestamps_are_monotone():
    eng = _engine(B=1)
    eng.add(_req(0, plen=4, max_new=3))
    r = eng.run()[0]
    assert r.t_enqueue <= r.t_admit <= r.t_first <= r.t_done
    assert r.queue_ms() >= 0 and r.ttft_ms() > 0
    assert r.ms_per_token() is not None and r.ms_per_token() >= 0


def test_step_deadline_miss_counter():
    eng = _engine("echo", B=1, step_deadline_ms=0.0)
    eng.add(Request(rid=0, prompt=np.asarray([1], np.int32), max_new=3))
    eng.run()
    assert eng.stats["steps"] > 0
    assert eng.stats["deadline_misses"] == eng.stats["steps"]


# ---------------------------------------------------------------------------
# Prompt buckets and slot lifecycle (the echo stub)
# ---------------------------------------------------------------------------
def _ones(n, rid=0, max_new=2):
    return rid, np.arange(1, n + 1), dict(max_new=max_new)


def test_bucket_function():
    assert [_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]


def test_ragged_prompts_share_one_prefill_compile():
    eng = _engine("echo", B=4)
    for rid, n in enumerate((5, 6, 7, 8)):
        eng.add(Request(rid=rid, prompt=np.arange(1, n + 1).astype(np.int32),
                        max_new=2))
    eng.run()
    assert eng.stats["prefill_compiles"] == 1
    assert eng.fault_report()["prefill_bucket_shapes"] == [8]
    eng.add(Request(rid=9, prompt=np.asarray([4, 5], np.int32), max_new=2))
    eng.run()
    assert eng.stats["prefill_compiles"] == 2
    assert eng.fault_report()["prefill_bucket_shapes"] == [2, 8]
    _serve_both([_ones(n, rid) for rid, n in enumerate((5, 6, 7, 8))],
                "echo", B=4)


def test_pad_unsafe_model_prefills_at_exact_lengths():
    eng, _ = _serve_both([_ones(n, rid) for rid, n in enumerate((5, 6, 7,
                                                                 5))],
                         "echo", B=4, pad_unsafe=True)
    assert eng.stats["prefill_compiles"] == 3
    assert eng.fault_report()["prefill_bucket_shapes"] == [5, 6, 7]


def test_bucket_clamped_to_capacity():
    eng, _ = _serve_both([_ones(7, 0, 1)], "echo", B=1, capacity=8)
    assert eng.fault_report()["prefill_bucket_shapes"] == [8]


def test_padded_prefill_reads_the_real_last_token():
    _, done = _serve_both([(0, [9, 2, 6], dict(max_new=3))], "echo", B=1)
    want = [ref_edge._f(6)]                     # from the REAL last token
    for _ in range(2):
        want.append(ref_edge._f(want[-1]))
    assert done[0].out == want


def test_max_new_one_yields_exactly_one_token():
    _, done = _serve_both([(0, [5], dict(max_new=1))], "echo", B=2)
    assert len(done) == 1 and done[0].done
    assert done[0].out == [ref_edge._f(5)]


def test_more_requests_than_slots_recycles_in_order():
    _, done = _serve_both([(rid, [rid + 1], dict(max_new=2))
                           for rid in range(5)], "echo", B=2)
    assert [r.rid for r in done] == [0, 1, 2, 3, 4]
    for r in done:
        assert r.out == [ref_edge._f(r.rid + 1),
                         ref_edge._f(ref_edge._f(r.rid + 1))]


def test_step_with_empty_queue_and_active_slots_decodes():
    eng = _engine("echo", B=2)
    eng.add(Request(rid=0, prompt=np.asarray([3], np.int32), max_new=3))
    assert eng.step() == [] and not eng.queue
    done = eng.step()
    assert [r.rid for r in done] == [0] and len(done[0].out) == 3


def test_step_on_idle_engine_is_a_noop():
    eng = _engine("echo")
    assert eng.step() == [] and eng.stats["steps"] == 0


def test_fault_report_on_probeless_engine():
    eng = _engine("echo", B=1)
    eng.add(Request(rid=0, prompt=np.asarray([1], np.int32), max_new=2))
    eng.run()
    rep = eng.fault_report()
    assert rep["steps"] > 0 and not rep["probe_fallback_active"]
    assert "probe_escaped_outputs" not in rep and "faults" not in rep


# ---------------------------------------------------------------------------
# Sampling: the port's own seeded generator
# ---------------------------------------------------------------------------
def _sampled(seed, temperature=1.0, max_new=8):
    eng = _engine("echo", B=2, temperature=temperature, seed=seed)
    for rid in range(2):
        eng.add(Request(rid=rid, prompt=np.asarray([rid + 1], np.int32),
                        max_new=max_new))
    return tuple(tuple(r.out) for r in eng.run())


def test_temperature_sampling_is_seed_deterministic():
    assert _sampled(seed=1) == _sampled(seed=1)


def test_temperature_sampling_varies_across_seeds_and_steps():
    a = _sampled(seed=1)
    assert a != _sampled(seed=2)
    assert a != _sampled(seed=1, temperature=0.0)
    # the tokens a request samples differ from step to step
    assert all(len(set(chain)) > 1 for chain in a)


def test_greedy_ignores_seed():
    assert _sampled(seed=1, temperature=0.0) == \
        _sampled(seed=2, temperature=0.0)


def test_sampling_follows_the_distribution():
    """At a low temperature sampling is greedy; the step seeds are
    distinct for every (seed, step)."""
    from repro_torch.serve.engine import _sample_seed
    assert _sampled(seed=3, temperature=1e-3) == \
        _sampled(seed=3, temperature=0.0)
    seeds = {_sample_seed(s, t) for s in range(4) for t in range(64)}
    assert len(seeds) == 4 * 64


# ---------------------------------------------------------------------------
# Degradation under fabric faults
# ---------------------------------------------------------------------------
def _probe(fm, d=16, n=6):
    w = np.linspace(-1, 1, d * n).reshape(d, n).astype(np.float32)
    cfg = FabricConfig(n_blocks=4, rows=128, cols=16)
    return FabricLinearProbe(w, cfg=cfg, bits=8, max_steps=8, faults=fm,
                             device="cpu")


def test_probe_retry_heals_and_serving_continues():
    fm = FaultModel(bit_rate=0.05, seed=0, scrub=False, heal_after=1)
    eng = _engine("echo", B=1, fabric_probe=_probe(fm), probe_retries=2)
    eng.add(Request(rid=0, prompt=np.asarray([2], np.int32), max_new=2))
    done = eng.run()
    assert len(done) == 1 and len(done[0].out) == 2
    rep = eng.fault_report()
    assert rep["probe_retries"] == 1 and rep["probe_fallbacks"] == 0
    assert not rep["probe_fallback_active"]
    assert rep["faults"]["escaped"] == 1


def test_probe_exhausted_retries_fall_back_permanently():
    fm = FaultModel(bit_rate=0.05, seed=0, scrub=False)
    eng = _engine("echo", B=1, fabric_probe=_probe(fm), probe_retries=1)
    eng.add(Request(rid=0, prompt=np.asarray([2], np.int32), max_new=3))
    done = eng.run()
    assert len(done) == 1 and len(done[0].out) == 3
    rep = eng.fault_report()
    assert rep["probe_fallbacks"] == 1 and rep["probe_fallback_active"]
    assert rep["probe_retries"] == 1
    events_at_fallback = fm.injection_events
    assert eng.stats["steps"] >= 2
    assert fm.injection_events == events_at_fallback


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(_CountModel(), params={})


# ---------------------------------------------------------------------------
# The port's LM served (the LM legs of tests/test_pim_serve.py)
# ---------------------------------------------------------------------------
def _lm(arch, seed):
    cfg = get_config(arch, smoke=True)
    return LM(cfg, device="cpu"), init_numpy(cfg, seed, device="cpu")


@pytest.mark.parametrize("arch,seed,chunk", [
    ("llama3.2-1b", 4, None), ("qwen2-0.5b", 3, 8),
    ("recurrentgemma-9b", 6, None)])
def test_serve_engine_matches_manual_decode(arch, seed, chunk):
    """The engine's chain equals a manual greedy decode at the engine's
    shapes (recurrentgemma's unstacked "rest" layers too; qwen2 with a
    prompt streamed through chunked prefill)."""
    model, params = _lm(arch, seed)
    prompt = np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8][
        :12 if chunk else 5], np.int32)
    eng = ServeEngine(model, params, batch_slots=2, capacity=32,
                      prefill_chunk=chunk, device="cpu")
    eng.add(Request(rid=0, prompt=prompt, max_new=6))
    done = eng.run()
    assert len(done) == 1 and len(done[0].out) == 6
    if chunk is None:
        bucket = _bucket(len(prompt)) if model.prefill_pad_safe else None
        assert done[0].out == chip_smoke.manual_greedy(model, params, prompt, 6, 2,
                                             32, bucket)
    else:
        whole = ServeEngine(model, params, batch_slots=2, capacity=32,
                            device="cpu")
        whole.add(Request(rid=0, prompt=prompt, max_new=6))
        assert whole.run()[0].out == done[0].out


def test_serve_engine_continuous_batching():
    model, params = _lm("qwen2-0.5b", 5)
    eng = ServeEngine(model, params, batch_slots=2, capacity=32,
                      device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, 4).astype(np.int32)
               for _ in range(5)]
    for rid, p in enumerate(prompts):
        eng.add(Request(rid=rid, prompt=p, max_new=4))
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    for r in done:
        assert r.out == chip_smoke.manual_greedy(model, params, prompts[r.rid], 4, 2,
                                       32, 4)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b",
                                  "deepseek-v2-lite"])
def test_serve_engine_keeps_its_caches_in_place(arch):
    """The continuous-batching case above (two slots, five requests)
    step by step: the engine's caches stay the same object and every
    leaf at the same address from its first step to its last, and each
    chain equals the manual greedy decode."""
    model, params = _lm(arch, 5)
    eng = ServeEngine(model, params, batch_slots=2, capacity=32,
                      device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, 4).astype(np.int32)
               for _ in range(5)]
    for rid, p in enumerate(prompts):
        eng.add(Request(rid=rid, prompt=p, max_new=4))
    caches = eng.caches
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    done, steps = [], 0
    while eng.queue or any(s is not None for s in eng.slots):
        done += eng.step()
        steps += 1
        assert eng.caches is caches
        assert [t.data_ptr() for t in tree_leaves(caches)] == ptrs, steps
    assert steps > 4 and sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    bucket = 4 if model.prefill_pad_safe else None
    for r in done:
        assert r.out == chip_smoke.manual_greedy(
            model, params, prompts[r.rid], 4, 2, 32, bucket)


# ---------------------------------------------------------------------------
# Which stacks decode through a CUDA graph (_decode_graph_takes)
# ---------------------------------------------------------------------------
#: the zoo's stacks whose every decode layer is GQA attention with a
#: dense FFN
GRAPHED_ARCHS = ("granite-20b", "llama3.2-1b", "qwen2-0.5b",
                 "h2o-danube-1.8b", "chameleon-34b")
ALL_ARCHS = list_archs() + ["deepseek-v2-lite"]


def _stack(arch, kv_bits=None, weight_bits=None):
    import dataclasses

    cfg = get_config(arch, smoke=True)
    if kv_bits:
        cfg = dataclasses.replace(cfg, kv_quant_bits=kv_bits)
    model = LM(cfg, device="cpu")
    params = init_numpy(cfg, 0, device="cpu")
    if weight_bits:
        params = quantize_tree(params, weight_bits)
    return model, params, model.init_cache(2, 16)


def _as_if_on_card(monkeypatch):
    """The predicates' device test answered as on the card: a plain
    tensor counts as a CUDA one."""
    monkeypatch.setattr(mattn, "_plain_cuda",
                        lambda t: type(t) is torch.Tensor)


@pytest.mark.parametrize("arch,kv_bits,weight_bits", [
    (a, None, None) for a in ALL_ARCHS] + [
    ("h2o-danube-1.8b", 8, None), ("h2o-danube-1.8b", 4, None),
    ("h2o-danube-1.8b", None, 8), ("qwen2-0.5b", None, 4)])
def test_decode_graph_takes_dense_gqa_stacks_only(monkeypatch, arch,
                                                  kv_bits, weight_bits):
    """Dense GQA stacks in bf16 qualify on their layer types; latent
    attention, experts, recurrent layers, an encoder-decoder, a quantized
    KV cache and quantized weights do not.  On the host no stack does."""
    model, params, caches = _stack(arch, kv_bits, weight_bits)
    assert not serve_engine._decode_graph_takes(model, params, caches)
    _as_if_on_card(monkeypatch)
    want = arch in GRAPHED_ARCHS and not kv_bits and not weight_bits
    assert serve_engine._decode_graph_takes(model, params, caches) == want
    assert not serve_engine._decode_graph_takes(_CountModel(), {}, {})


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-0.5b"])
def test_engine_on_the_host_decodes_eagerly(arch):
    """On the CPU a graphable stack's engine runs every decode step
    eagerly: ``serve.decode_eager`` and ``stats["decode_eager"]`` once a
    step, no replay, and each chain the manual greedy decode's."""
    model, params = _lm(arch, 2)
    eng = ServeEngine(model, params, batch_slots=2, capacity=32,
                      device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, n).astype(np.int32)
               for n in (3, 4, 2)]
    for rid, p in enumerate(prompts):
        eng.add(Request(rid=rid, prompt=p, max_new=5))
    trace.enable()
    try:
        done = eng.run()
        _, counters = trace.take()
    finally:
        trace.disable()
    assert eng._decode.takes is False and eng._decode.graph is None
    assert counters["serve.decode_eager"] == eng.stats["decode_eager"] \
        == eng._decode_count > 0
    assert "serve.decode_graph" not in counters
    assert eng.stats["decode_graph_replays"] == 0
    for r in done:
        assert r.out == chip_smoke.manual_greedy(
            model, params, prompts[r.rid], 5, 2, 32,
            _bucket(len(prompts[r.rid])))


# ---------------------------------------------------------------------------
# chip_smoke's serve phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_smoke_serve_phase_counts_its_kernel(monkeypatch):
    """``chip_smoke.phase_serve`` at smoke widths on the CPU with a
    128 x 8 grid and a counting stand-in for the ``lane_fold`` kernel
    wherever packed planes fold: every request served, request 0's chain
    equal to the manual decode, the probe's outputs equal to
    ``observe_ref`` and ``lane_fold`` launched by the probe."""
    def fold(x, width):
        fold.launches += 1
        out = bp.lane_fold_torch(list(x), width)
        return torch.stack([torch.zeros_like(x[0, 0]) if p is None else p
                            for p in out])

    fold.launches = 0
    monkeypatch.setattr(bp, "lane_fold_cuda", fold)
    monkeypatch.setattr(bp, "use_kernel_fold", lambda device, packed: packed)
    res = chip_smoke.phase_serve(
        0, dev="cpu", cfg=get_config("qwen2-0.5b", True),
        fabric_cfg=FabricConfig(n_blocks=8, rows=128, cols=8),
        prompts=(5, 12, 16, 33, 40, 50), capacity=64, chunk=32)
    assert res["lane_fold_launches"] > 0
    assert res["requests_done"] == 6 and res["probe_steps"] == 2
    assert res["probe_equals_observe_ref"] and res["chain_equals_manual"]
