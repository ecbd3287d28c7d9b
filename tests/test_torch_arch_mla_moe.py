"""DeepSeek-V2-Lite's layers in the port (``configs/deepseek_v2_lite.py``:
multi-head latent attention, DeepSeekMoE with shared experts, a leading
dense layer, YaRN) against the plain float32 reference of the benchmark
(``portbench/reference/deepseek_v2.py``, loaded from its file, so there
is one copy), at the smoke config on seeded weights
(``portbench/pb_mla_moe.weights``).  The reference has no counterpart in
the JAX package's zoo.

Tolerances, on logits of unit spread (the head's ``N(0, 1) *
d_model**-0.5`` over a normed state), per position the largest absolute
difference over the vocabulary:

* ``TYPICAL`` 0.1 on the median position: the port computes in bf16 and
  rounds its logits to bf16 (median 0.038-0.050 over seeds 20-29); the
  fp8 control (every projection and expert through e4m3, the reference's
  ``quant="fp8"``) reads 0.48-0.65 there, so it fails this bound.  Where
  a sequence is prefilled and then decoded, the decode positions are held
  to it on their own (median 0.045-0.054 over seeds 21-30; the fp8
  control 0.54-0.62; the absorbed decode without YaRN's ``mscale**2``
  1.18-1.46, without the rotation 2.26-2.73), since the prefill
  positions, the majority, would carry the median past a fault of the
  decode alone;
* ``FLIP`` 0.6 on every position: a router near a tie (two experts'
  probabilities equal to 4 digits) picks another expert in bf16 than in
  float32, and at the smoke size's 3 of 8 experts, with gates near 0.17,
  that moves one position's logits by up to 0.42 (seeds 20-29).
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

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.configs.mla import MLAConfig
from repro_torch.models import mla, moe
from repro_torch.models.common import yarn_inv_freq
from repro_torch.models.model import LM
from repro_torch.serve.engine import Request, ServeEngine

BENCH = Path(__file__).resolve().parents[1] / "portbench"
TYPICAL, FLIP = 0.1, 0.6


def _load(name, path, package=False):
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py" if package else path,
        submodule_search_locations=[str(path)] if package else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_load("portbench_reference", BENCH / "reference", package=True)
ref = importlib.import_module("portbench_reference.deepseek_v2")
pb_mla_moe = _load("portbench_pb_mla_moe", BENCH / "pb_mla_moe.py")


@pytest.fixture(scope="module")
def cfg():
    return get_config("deepseek-v2-lite", smoke=True)


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
    w = pb_mla_moe.weights(cfg, seed, "cpu")
    tokens = _tokens(cfg, seed, 48)
    want = ref.forward(w, cfg, tokens)
    got, _ = model.apply(w, tokens=tokens[None])
    assert _within(_errors(got[0], want))
    ctl = ref.forward(w, cfg, tokens, quant="fp8")
    assert _errors(ctl, want).median().item() > TYPICAL


PREFILLED = 24


def _prefill_then_decode(model, w, cfg, tokens):
    """Logits of ``tokens`` (40,): the first ``PREFILLED`` prefilled into a
    40-slot latent cache, the rest decoded one at a time."""
    logits, caches = model.prefill(w, tokens=tokens[None, :PREFILLED],
                                   capacity=40)
    cache = caches["lead"][0]["mla"]
    assert cache["c"].shape == (1, 40, cfg.mla.kv_lora_rank)
    assert cache["k_pe"].shape == (1, 40, cfg.mla.qk_rope_head_dim)
    assert cache["pos"][0, :PREFILLED].tolist() == list(range(PREFILLED))
    assert (cache["pos"][0, PREFILLED:] == -1).all()
    got = [logits[0]]
    for i in range(PREFILLED, 40):
        step, caches = model.decode_step(w, caches, tokens[None, i:i + 1],
                                         torch.tensor([i], dtype=torch.int32))
        got.append(step[0])
    return torch.cat(got)


@pytest.mark.parametrize("seed", [21, 24])
def test_prefill_then_decode_through_the_latent_cache(cfg, model, seed):
    """Prefill 24 tokens into a 40-slot latent cache, then decode 16 more
    one at a time (absorbed ``W_uk``/``W_uv``), against the reference's
    full forward over the 40; the decoded positions' median on its own."""
    w = pb_mla_moe.weights(cfg, seed, "cpu")
    tokens = _tokens(cfg, seed, 40)
    want = ref.forward(w, cfg, tokens)
    err = _errors(_prefill_then_decode(model, w, cfg, tokens), want)
    assert _within(err)
    assert err[PREFILLED:].median().item() < TYPICAL
    ctl = _errors(ref.forward(w, cfg, tokens, quant="fp8"), want)
    assert ctl[PREFILLED:].median().item() > TYPICAL


def _unscaled(c):
    return c.mla.qk_head_dim ** -0.5


def _unrotated(x, *args, **kwargs):
    return x


@pytest.mark.parametrize("name,fault", [("softmax_scale", _unscaled),
                                        ("rope_pairs", _unrotated)],
                         ids=["mscale_dropped", "rotation_dropped"])
def test_decode_bound_sees_a_fault_of_the_decode_alone(cfg, model,
                                                       monkeypatch, name,
                                                       fault):
    """The decode-only median bound fails a fault planted in the absorbed
    decode alone (``mla_decode`` without YaRN's ``mscale**2``, or without
    the rotation of ``q_pe`` and ``k_pe``), which the median over all
    positions (the prefilled ones the majority) let pass on seed 21."""
    w = pb_mla_moe.weights(cfg, 21, "cpu")
    tokens = _tokens(cfg, 21, 40)
    want = ref.forward(w, cfg, tokens)
    real = model.decode_step

    def faulty(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(mla, name, fault)
            return real(*args, **kwargs)

    monkeypatch.setattr(model, "decode_step", faulty)
    err = _errors(_prefill_then_decode(model, w, cfg, tokens), want)
    assert err[:PREFILLED].median().item() < TYPICAL
    assert err[PREFILLED:].median().item() > TYPICAL


def _serve(model, w, prompts, slots=4, capacity=64, max_new=8):
    eng = ServeEngine(model, w, batch_slots=slots, capacity=capacity,
                      device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add(r)
    done = eng.run()
    assert len(done) == len(reqs)
    return reqs


def test_serve_engine_tokens_against_reference(cfg, model):
    """Four slots, six requests of mixed lengths (prefilled at buckets 8,
    16 and 32, the pads routed too); each served token's logit lies
    within the served-logit-gap limit of the reference's best (the
    benchmark's check: the smoke cell's program reads up to 0.32, its
    fp8 control from 0.52, on seeds 1-6)."""
    w = pb_mla_moe.weights(cfg, 3, "cpu")
    lens = [5, 13, 30, 9, 21, 17]
    prompts = [_tokens(cfg, 100 + i, n).numpy() for i, n in enumerate(lens)]
    widest = 0.0
    for req in _serve(model, w, prompts):
        assert len(req.out) == 8
        seq = torch.as_tensor(np.concatenate([req.prompt, req.out]))
        gaps = ref.served_gaps(ref.forward(w, cfg, seq), len(req.prompt),
                               req.out)
        widest = max(widest, max(gaps))
    assert widest < 0.45


def test_a_request_alone_and_batched(cfg, model):
    """A request's decode logits are its own whatever its batchmates: the
    MoE drops no pair, so a lane's rows meet the same experts."""
    w = pb_mla_moe.weights(cfg, 4, "cpu")
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


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "mixtral-8x7b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_routing_onto_one_expert_drops_nothing(arch, mode):
    """Every token prefers expert 0 (a router column far above the
    others, inputs of one sign): the capacity dispatch of training would
    keep ``capacity`` of them; prefill and decode compute them all, each
    token's output the same as when it is alone."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    p["router"] = p["router"].clone()
    p["router"][:, 0] = 10.0
    x = torch.rand((4, 6, cfg.d_model),
                   generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    if mode == "decode":
        x = x.reshape(24, 1, cfg.d_model)
    all_at_once, _ = moe.moe_apply(p, x, cfg, mode)
    one_by_one = torch.cat([moe.moe_apply(p, x[i:i + 1], cfg, mode)[0]
                            for i in range(x.shape[0])])
    torch.testing.assert_close(all_at_once, one_by_one, rtol=0.02,
                               atol=0.02)
    dropped, _ = moe.moe_apply(p, x.reshape(1, 24, -1), cfg, "train")
    assert not torch.allclose(dropped.reshape(x.shape), one_by_one,
                              rtol=0.02, atol=0.02)


def test_yarn_frequencies():
    """``inv_freq_i = f_i / 40 * r_i + f_i * (1 - r_i)`` with ``f_i =
    10000**(-2i/64)`` and ``r_i = clamp((i - 10) / (23 - 10), 0, 1)``;
    cos and sin unscaled, the scores' factor ``(0.1 * 0.707 * ln 40 +
    1)**2``."""
    ys = get_config("deepseek-v2-lite").rope_scaling
    assert ys.correction_range(64, 10000.0) == (10, 23)
    i = torch.arange(32, dtype=torch.float64)
    f = 10000.0 ** (-2 * i / 64)
    r = torch.clamp((i - 10) / 13, 0, 1)
    want = f / 40 * r + f * (1 - r)
    got = yarn_inv_freq(64, 10000.0, ys).to(torch.float64)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert ys.cos_scale == 1.0
    assert ys.attn_scale == pytest.approx((0.1 * 0.707 * np.log(40) + 1) ** 2)
    torch.testing.assert_close(
        ref.yarn_inv_freq(64, 10000.0, ys).to(torch.float64), want,
        rtol=1e-6, atol=0)


def test_config_file_is_the_zoo_entry_at_published_widths():
    f = json.loads((BENCH / "configs" / "deepseek-v2-lite.json").read_text())
    pub = f["published"]
    assert f["reduced"] == []
    assert {k: f[k] for k in pub} == pub
    mc = get_config("deepseek-v2-lite")
    assert isinstance(mc, MLAConfig)
    assert dataclasses.replace(mc, **f["model"]) == mc
    m, e, ys = mc.mla, mc.moe, mc.rope_scaling
    assert (mc.n_layers, mc.d_model, mc.n_heads, mc.d_ff, mc.vocab) == (
        pub["num_hidden_layers"], pub["hidden_size"],
        pub["num_attention_heads"], pub["intermediate_size"],
        pub["vocab_size"])
    assert (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
            m.v_head_dim) == (pub["kv_lora_rank"], pub["qk_nope_head_dim"],
                              pub["qk_rope_head_dim"], pub["v_head_dim"])
    assert pub["q_lora_rank"] is None and mc.hd == m.qk_head_dim
    assert (e.num_experts, e.top_k, e.d_ff, e.n_shared, e.norm_topk_prob,
            e.routed_scaling_factor) == (
        pub["n_routed_experts"], pub["num_experts_per_tok"],
        pub["moe_intermediate_size"], pub["n_shared_experts"],
        pub["norm_topk_prob"], pub["routed_scaling_factor"])
    assert pub["scoring_func"] == "softmax" and pub["topk_method"] == "greedy"
    assert mc.first_k_dense == pub["first_k_dense_replace"]
    assert pub["moe_layer_freq"] == 1 and not pub["tie_word_embeddings"]
    rs = pub["rope_scaling"]
    assert (ys.factor, ys.original_max_position, ys.beta_fast, ys.beta_slow,
            ys.mscale, ys.mscale_all_dim) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"],
        rs["mscale_all_dim"])
    assert (mc.rope_theta, mc.norm_eps) == (pub["rope_theta"],
                                            pub["rms_norm_eps"])
    assert round(mc.param_count() / 1e9, 1) == 15.7


def test_latent_cache_refuses_kv_quantization():
    with pytest.raises(ValueError, match="kv_quant_bits"):
        dataclasses.replace(get_config("deepseek-v2-lite", smoke=True),
                            kv_quant_bits=8)


def test_spans_and_counters(cfg, model):
    """MLA's and the MoE's spans sit inside the model's, and the MoE's
    host and device counters count what it routed."""
    w = pb_mla_moe.weights(cfg, 5, "cpu")
    tokens = _tokens(cfg, 5, 12)[None]
    trace.disable()
    trace.take()
    trace.enable()
    try:
        _, caches = model.prefill(w, tokens=tokens, capacity=16)
        model.decode_step(w, caches, tokens[:, :1],
                          torch.tensor([12], dtype=torch.int32))
        dev = trace.device_counters()
        spans, counters = trace.take()
    finally:
        trace.disable()
    names = [s[0] for s in spans]
    parent = {i: spans[s[3]][0] for i, s in enumerate(spans)
              if s[3] is not None}
    for inner, outer in (("mla.latent", "model.attention"),
                         ("mla.attend", "model.attention"),
                         ("moe.route", "model.mlp"),
                         ("moe.experts", "model.mlp"),
                         ("moe.combine", "model.mlp"),
                         ("moe.shared", "model.mlp")):
        at = [i for i, n in enumerate(names) if n == inner]
        assert at and all(parent[i] == outer for i in at), inner
    moe_layers = cfg.n_layers - cfg.first_k_dense
    k = cfg.moe.top_k
    assert counters["moe.calls"] == 2 * moe_layers
    assert counters["moe.routed_rows"] == (12 + 1) * k * moe_layers
    rows = dev["moe.expert_rows"]
    assert rows.shape == (cfg.n_layers, cfg.moe.num_experts)
    assert rows[0].sum() == 0
    assert rows[1:].sum(-1).tolist() == [(12 + 1) * k] * moe_layers
    hits = dev["moe.decode_expert_hits"]
    assert hits[1:].sum(-1).tolist() == [k] * moe_layers
