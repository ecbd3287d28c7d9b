"""Jamba's hybrid stack in the port (``configs/jamba.py``,
``configs/jamba2_mini.py``: Mamba-1 mixers with gained RMSNorms on dt, B
and C beside GQA attention without positions, each followed by a dense
or a 16-expert top-2 FFN) against the plain float32 reference of the
benchmark (``portbench/reference/jamba.py``, loaded from its file, so
there is one copy), at the smoke config on seeded weights
(``portbench/pb_jamba.weights``).  The reference has no counterpart in
the JAX package's zoo.  Also the streamed scan that takes any prompt
length, which falcon-mamba shares.

Tolerances, on logits of unit spread (the head's ``N(0, 1) *
d_model**-0.5`` over a normed state), per position the largest absolute
difference over the vocabulary:

* ``TYPICAL`` 0.4 on the median position: the port computes in bf16 (the
  mixer's projections, its conv, the residual stream) and rounds its
  logits to bf16 (median 0.10-0.20 over seeds 20-29, the decoded
  positions' own 0.11-0.21); the fp8 control (every projection, expert
  and the head through e4m3, the reference's ``quant="fp8"``) reads
  0.86-0.98 there (decoded 0.89-1.06), so it fails this bound.  Where a
  sequence is prefilled and then decoded, the decoded positions are held
  to it on their own;
* ``FLIP`` 2.5 on every position: a router near a tie picks another
  expert in bf16 than in float32, which at the smoke size's 2 of 16
  experts moves one position's logits by up to 2.24 (seeds 20-29).
"""

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.configs.jamba import JambaConfig
from repro_torch.models import recurrence, ssm
from repro_torch.models.common import softplus
from repro_torch.models.model import LM
from repro_torch.models.qweight import dq
from repro_torch.serve.engine import Request, ServeEngine

BENCH = Path(__file__).resolve().parents[1] / "portbench"
CATALOG_ROW = {
    "attn_layer_offset": 4, "attn_layer_period": 8,
    "expert_layer_offset": 1, "expert_layer_period": 2,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
    "mamba_dt_rank": 256, "mamba_expand": 2, "mamba_proj_bias": False,
    "max_position_embeddings": 262144, "model_type": "jamba",
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8,
    "num_logits_to_keep": 1, "rms_norm_eps": 1e-06, "sliding_window": None,
    "tie_word_embeddings": False, "use_mamba_kernels": True,
    "vocab_size": 65536}
TYPICAL, FLIP = 0.4, 2.5


def _load(name, path, package=False):
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py" if package else path,
        submodule_search_locations=[str(path)] if package else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_load("portbench_reference", BENCH / "reference", package=True)
ref = importlib.import_module("portbench_reference.jamba")
pb_jamba = _load("portbench_pb_jamba", BENCH / "pb_jamba.py")


@pytest.fixture(scope="module")
def cfg():
    return get_config("jamba2-mini", smoke=True)


@pytest.fixture(scope="module")
def model(cfg):
    return LM(cfg, device="cpu")


def _tokens(cfg, seed, n):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, n), dtype=torch.int32)


def _errors(got, want):
    """Per position, the largest absolute logit difference."""
    return (got.to(torch.float32) - want).abs().amax(-1)


def _within(err):
    return err.median().item() < TYPICAL and err.max().item() < FLIP


@pytest.mark.parametrize("seed", [20, 23, 26])
def test_apply_logits_against_reference(cfg, model, seed):
    w = pb_jamba.weights(cfg, seed, "cpu")
    tokens = _tokens(cfg, seed, 48)
    want = ref.forward(w, cfg, tokens)
    got, _ = model.apply(w, tokens=tokens[None])
    assert _within(_errors(got[0], want))
    ctl = ref.forward(w, cfg, tokens, quant="fp8")
    assert _errors(ctl, want).median().item() > TYPICAL


def _prefill_then_decode(model, w, tokens, prefilled, capacity):
    """Logits of ``tokens``: the first ``prefilled`` prefilled into
    ``capacity``-slot caches, the rest decoded one at a time."""
    logits, caches = model.prefill(w, tokens=tokens[None, :prefilled],
                                   capacity=capacity)
    got = [logits[0]]
    for i in range(prefilled, len(tokens)):
        step, caches = model.decode_step(w, caches, tokens[None, i:i + 1],
                                         torch.tensor([i], dtype=torch.int32))
        got.append(step[0])
    return torch.cat(got), caches


@pytest.mark.parametrize("seed", [21, 24])
def test_prefill_then_decode_through_both_state_kinds(cfg, model, seed):
    """Prefill 24 tokens, then decode 16 more one at a time: the Mamba
    layers through their conv and scan states, the attention layer
    through its 40-slot KV ring; against the reference's full forward
    over the 40, the decoded positions' median on its own."""
    w = pb_jamba.weights(cfg, seed, "cpu")
    tokens = _tokens(cfg, seed, 40)
    want = ref.forward(w, cfg, tokens)
    got, caches = _prefill_then_decode(model, w, tokens, 24, 40)
    err = _errors(got, want)
    assert _within(err)
    assert err[24:].median().item() < TYPICAL
    ctl = _errors(ref.forward(w, cfg, tokens, quant="fp8"), want)
    assert ctl[24:].median().item() > TYPICAL
    unit = caches["unit"]
    di = cfg.ssm.expand * cfg.d_model
    assert set(unit["b4"]) == {"kv"} and set(unit["b0"]) == {"ssm"}
    assert unit["b4"]["kv"]["k"].shape == (1, 1, 40, cfg.n_kv_heads, cfg.hd)
    assert unit["b4"]["kv"]["pos"][0, 0].tolist() == list(range(40))
    assert unit["b0"]["ssm"]["h"].shape == (1, 1, di, cfg.ssm.state_dim)


def test_attention_has_no_rotation(cfg, model):
    """The reference's attention has no positions; the port with a rotary
    embedding put back (``rope_theta`` 10000) fails the median bound, in
    the prefill and in the decode alone."""
    w = pb_jamba.weights(cfg, 22, "cpu")
    tokens = _tokens(cfg, 22, 40)
    want = ref.forward(w, cfg, tokens)
    roped = LM(dataclasses.replace(cfg, rope_theta=10_000.0), device="cpu")
    got, _ = _prefill_then_decode(roped, w, tokens, 24, 40)
    err = _errors(got, want)
    assert err[:24].median().item() > TYPICAL
    assert err[24:].median().item() > TYPICAL
    mine, _ = _prefill_then_decode(model, w, tokens, 24, 40)
    assert _within(_errors(mine, want))


def _serve(model, w, prompts, slots=4, capacity=64, max_new=8):
    eng = ServeEngine(model, w, batch_slots=slots, capacity=capacity,
                      device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add(r)
    with torch.no_grad():
        done = eng.run()
    assert len(done) == len(reqs)
    return eng, reqs


def test_serve_engine_tokens_against_reference(cfg, model):
    """Four slots, six requests of mixed lengths, each prefilled at its
    exact length (a recurrent stack takes no pads) and merged into its
    lane's conv, scan and KV states; each served token's logit lies
    within the served-logit-gap limit of the reference's best (the
    benchmark's check: the smoke cell's program reads up to 0.473, its
    fp8 control from 0.975, on seeds 1-12)."""
    w = pb_jamba.weights(cfg, 3, "cpu")
    lens = [5, 13, 30, 9, 21, 17]
    prompts = [_tokens(cfg, 100 + i, n).numpy() for i, n in enumerate(lens)]
    eng, reqs = _serve(model, w, prompts)
    assert eng.stats["prefill_tokens"] == sum(lens)
    assert eng.stats["decode_eager"] > 0 and \
        eng.stats["decode_graph_replays"] == 0
    widest = 0.0
    for req in reqs:
        assert len(req.out) == 8
        seq = torch.as_tensor(np.concatenate([req.prompt, req.out]))
        gaps = ref.served_gaps(ref.forward(w, cfg, seq), len(req.prompt),
                               req.out)
        widest = max(widest, max(gaps))
    assert widest < 0.68


def test_a_request_alone_and_batched(cfg, model):
    """A request's decode logits are its own whatever its batchmates: the
    MoE drops no pair and each lane's states are its own."""
    w = pb_jamba.weights(cfg, 4, "cpu")
    mine = _tokens(cfg, 7, 20)

    def lane0(others):
        seqs = [mine] + [_tokens(cfg, 50 + j, 20) for j in range(others)]
        batch = torch.stack(seqs)
        logits, caches = model.prefill(w, tokens=batch[:, :12], capacity=32)
        out = [logits[0, -1]]
        for i in range(12, 20):
            step, caches = model.decode_step(
                w, caches, batch[:, i:i + 1],
                torch.full((len(seqs),), i, dtype=torch.int32))
            out.append(step[0, 0])
        return torch.stack(out).to(torch.float32)

    alone, batched = lane0(0), lane0(3)
    assert _errors(batched, alone).max().item() < TYPICAL


def test_engine_serves_a_request_alone_and_among_others(cfg, model):
    """The engine's greedy tokens for a request are the same served alone
    and among five others that fill and refill the slots."""
    w = pb_jamba.weights(cfg, 6, "cpu")
    prompts = [_tokens(cfg, 200 + i, n).numpy()
               for i, n in enumerate([11, 27, 6, 19, 33, 14])]
    _, alone = _serve(model, w, prompts[2:3], slots=1)
    _, among = _serve(model, w, prompts)
    assert among[2].out == alone[0].out


@pytest.mark.parametrize("n", [255, 257, 300, 513])
def test_prefill_takes_any_length(cfg, model, n):
    """A prompt of any length is prefilled (the scan's last chunk of 256
    ragged, the attention's last chunk of 1024 too), then two tokens are
    decoded from its states; all against the reference."""
    w = pb_jamba.weights(cfg, n, "cpu")
    tokens = _tokens(cfg, n, n + 2)
    want = ref.forward(w, cfg, tokens)
    got, _ = _prefill_then_decode(model, w, tokens, n, n + 2)
    err = _errors(got, want)
    assert _within(err)
    assert err[n:].max().item() < FLIP


def test_falcon_mamba_prefills_300_tokens_as_it_decodes_them():
    """falcon-mamba's prefill at 300 tokens (it raised for any length
    past 256 that is no multiple of 256) against its own decode of the
    same tokens one at a time from empty states: the logits within bf16
    rounding (0.05; the float32 scan orders differ in the last bits,
    which a bf16 logit shows as at most a few of its steps), and every
    layer's scan state within rtol 1e-4."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    m = LM(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    tokens = _tokens(cfg, 9, 300)
    with torch.no_grad():
        logits, pre = m.prefill(p, tokens=tokens[None])
        caches = m.init_cache(1, 300, device="cpu")
        step = []
        for i in range(300):
            s, caches = m.decode_step(p, caches, tokens[None, i:i + 1],
                                      torch.tensor([i], dtype=torch.int32))
            step.append(s[0, 0])
    assert logits.shape == (1, 300, cfg.vocab)
    torch.testing.assert_close(logits[0].float(),
                               torch.stack(step).float(), rtol=0, atol=0.05)
    torch.testing.assert_close(pre["unit"]["b0"]["ssm"]["h"],
                               caches["unit"]["b0"]["ssm"]["h"],
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(pre["unit"]["b0"]["ssm"]["conv"],
                               caches["unit"]["b0"]["ssm"]["conv"],
                               rtol=0, atol=0)


def _whole_sequence_inner(params, xi, dt_r, Bm, Cm, h0, chunk):
    """The selective scan as the port formed it before it streamed: the
    decay, the input and the states over the whole sequence."""
    dt = softplus(dt_r.to(torch.float32)
                  @ dq(params["dt_w"], torch.float32).to(torch.float32)
                  + params["dt_b"])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt[..., None] * A)
    bx = (dt * xi.to(torch.float32))[..., None] * Bm[:, :, None, :]
    S = xi.shape[1]
    hs, h = [], h0
    for c0 in range(0, S, chunk):
        pa, pb = recurrence._inclusive_scan(decay[:, c0:c0 + chunk],
                                            bx[:, c0:c0 + chunk])
        hc = pa * h[:, None] + pb
        h = hc[:, -1]
        hs.append(hc)
    hs = torch.cat(hs, dim=1)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm)
    return y + params["D"] * xi.to(torch.float32), h


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba2-mini"])
def test_streamed_scan_is_bit_identical_at_whole_chunks(arch, monkeypatch):
    """At 512 tokens (two chunks of 256) the streamed scan's outputs and
    last state are the whole-sequence scan's, bit for bit; so is the
    generic ``chunked_linear_scan`` against the same loop."""
    cfg = get_config(arch, smoke=True)
    p = ssm.ssm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn((2, 512, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    got, got_c = ssm.ssm_apply(p, x, cfg)
    monkeypatch.setattr(ssm, "_ssm_inner", _whole_sequence_inner)
    want, want_c = ssm.ssm_apply(p, x, cfg)
    assert torch.equal(got, want) and torch.equal(got_c["h"], want_c["h"])
    g = torch.Generator().manual_seed(3)
    a = torch.rand((2, 512, 3, 4), generator=g)
    b = torch.randn((2, 512, 3, 4), generator=g)
    h0 = torch.randn((2, 3, 4), generator=g)
    hs, h = recurrence.chunked_linear_scan(a, b, h0, chunk=256)
    ref_hs, ref_h = [], h0
    for c0 in (0, 256):
        pa, pb = recurrence._inclusive_scan(a[:, c0:c0 + 256],
                                            b[:, c0:c0 + 256])
        hc = pa * ref_h[:, None] + pb
        ref_h = hc[:, -1]
        ref_hs.append(hc)
    assert torch.equal(hs, torch.cat(ref_hs, 1)) and torch.equal(h, ref_h)


class _StateShapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns whose last two
    dims are ``(d_inner, d_state)``: a state, a decay or an input of the
    scan."""

    def __init__(self, di, st):
        super().__init__()
        self.di, self.st, self.shapes = di, st, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and \
                    tuple(t.shape[-2:]) == (self.di, self.st):
                self.shapes.add(tuple(t.shape))
        return out


def test_the_scan_holds_no_whole_sequence_state():
    """A Mamba mixer over 600 tokens makes no ``(B, S, d_inner, d_state)``
    tensor of the whole sequence: its scan's tensors span a chunk of 256
    time steps at most (the last one ragged, 88)."""
    cfg = get_config("jamba2-mini", smoke=True)
    p = ssm.ssm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn((1, 600, cfg.d_model)).to(torch.bfloat16)
    di = cfg.ssm.expand * cfg.d_model
    with _StateShapes(di, cfg.ssm.state_dim) as seen:
        ssm.ssm_apply(p, x, cfg)
    steps = {s[1] for s in seen.shapes if len(s) == 4}
    assert max(steps) == 256 and 88 in steps
    assert max(np.prod(s) for s in seen.shapes) \
        == 256 * di * cfg.ssm.state_dim


def test_published_sizes_and_the_first_stage():
    full, stage = get_config("jamba2-mini"), get_config("jamba2-mini-stage0")
    assert isinstance(full, JambaConfig)
    assert round(full.param_count() / 1e9, 2) == 51.57
    assert round(stage.param_count() / 1e9, 2) == 26.05
    assert dataclasses.replace(full, name=stage.name,
                               n_layers=stage.n_layers) == stage
    types = full.layer_types()
    assert [i for i, t in enumerate(types) if t == "attn"] == [4, 12, 20, 28]
    assert [i for i in range(32) if full.moe_at(i)] == list(range(1, 32, 2))
    unit, n, rest = stage.scan_plan()
    assert (unit, n, rest) == (types[:8], 2, [])
    assert stage.rope_theta is None and full.hd == 128
    with pytest.raises(ValueError, match="periods"):
        dataclasses.replace(full, n_layers=12)


def test_config_file_is_the_catalog_row_cut_to_the_first_stage():
    f = json.loads((BENCH / "configs" / "jamba2-mini.json").read_text())
    pub = f["published"]
    assert f["reduced"] == ["n_layers"]
    assert {k: f[k] for k in CATALOG_ROW} == CATALOG_ROW
    assert {k: pub[k] for k in CATALOG_ROW} == CATALOG_ROW
    assert set(pub) - set(CATALOG_ROW) == {"rope_theta"}
    assert pub["rope_theta"] is None
    mc = get_config(f["arch"])
    assert dataclasses.replace(mc, **f["model"]) == mc
    assert mc.n_layers == 16 == pub["num_hidden_layers"] // 2
    s, e = mc.ssm, mc.moe
    assert (mc.d_model, mc.n_heads, mc.n_kv_heads, mc.d_ff, mc.vocab,
            mc.norm_eps, mc.tie_embeddings) == (
        pub["hidden_size"], pub["num_attention_heads"],
        pub["num_key_value_heads"], pub["intermediate_size"],
        pub["vocab_size"], pub["rms_norm_eps"], pub["tie_word_embeddings"])
    assert (s.state_dim, s.conv_width, s.expand, s.dt_rank, s.inner_norms) \
        == (pub["mamba_d_state"], pub["mamba_d_conv"], pub["mamba_expand"],
            pub["mamba_dt_rank"], True)
    assert (e.num_experts, e.top_k, e.d_ff, e.n_shared, e.norm_topk_prob) \
        == (pub["num_experts"], pub["num_experts_per_tok"],
            pub["intermediate_size"], 0, False)
    assert (mc.attn_layer_period, mc.attn_layer_offset,
            mc.expert_layer_period, mc.expert_layer_offset) == (
        pub["attn_layer_period"], pub["attn_layer_offset"],
        pub["expert_layer_period"], pub["expert_layer_offset"])
    assert pub["sliding_window"] is None and mc.sliding_window is None
    assert pub["mamba_conv_bias"] and not pub["mamba_proj_bias"]
    assert "two-stage pipeline" in f["deployment"]


def test_spans_and_counters(cfg, model):
    """A Mamba layer's ``model.ssm`` holds ``ssm.conv`` and ``ssm.scan``;
    every layer's FFN is a ``model.mlp``, the routed ones holding the
    MoE's spans; the prefill counts its scanned tokens and chunks."""
    w = pb_jamba.weights(cfg, 5, "cpu")
    tokens = _tokens(cfg, 5, 300)[None]
    trace.disable()
    trace.take()
    trace.enable()
    try:
        _, caches = model.prefill(w, tokens=tokens, capacity=304)
        model.decode_step(w, caches, tokens[:, :1],
                          torch.tensor([300], dtype=torch.int32))
        spans, counters = trace.take()
    finally:
        trace.disable()
    names = [s[0] for s in spans]
    parent = {i: spans[s[3]][0] for i, s in enumerate(spans)
              if s[3] is not None}
    for inner, outer in (("ssm.conv", "model.ssm"),
                         ("ssm.scan", "model.ssm"),
                         ("moe.route", "model.mlp"),
                         ("moe.experts", "model.mlp"),
                         ("moe.combine", "model.mlp")):
        at = [i for i, n in enumerate(names) if n == inner]
        assert at and all(parent[i] == outer for i in at), inner
    n_ssm = cfg.layer_types().count("ssm")
    assert names.count("model.ssm") == 2 * n_ssm
    assert names.count("model.attention") == 2
    assert names.count("model.mlp") == 2 * cfg.n_layers
    assert counters["ssm.prefill_tokens"] == 300 * n_ssm
    assert counters["ssm.scan_chunks"] == 2 * n_ssm
    assert counters["moe.calls"] == 2 * cfg.n_layers // 2
