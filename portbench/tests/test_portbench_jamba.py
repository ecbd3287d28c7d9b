"""The Jamba hybrid's serve cell (``drivers/serve_hybrid.py``) at smoke size
on the CPU: a whole run's result line with its new per-layer metrics,
that module as the serve cells' module with this model's parts swapped
in, the work counts of ``pb_jamba`` against the config's parameter
count, and the SSM and scan-kernel metrics' readings of the spans, calls
and device times they are given."""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

import pb_harness as H
import pb_jamba
import run
from conftest import tiny_layout

CELL = "serve.jamba2-mini-smoke.longdoc-tiny"
FULL = "serve.jamba2-mini.longdoc"
NEW = ("ssm.decode_share", "ssm.prefill_share", "ssm.prefill_roofline",
       "moe.decode_share", "moe.byte_roofline")
#: judged along the served experts, over seeds 1-12 at 3 s on the CPU:
#: the program's gaps up to 0.0834 and margins up to 0.167, its fp8
#: control's from 0.277 and 0.712; each limit is the two's geometric mean
LIMITS = {"served_logit_gap": 0.15, "route_logit_margin": 0.34}


@pytest.fixture
def layout(tmp_path):
    from repro_torch.configs import get_config
    lay = tiny_layout(tmp_path, [])
    mc = get_config("jamba2-mini-stage0", smoke=True)
    flat = {k: v for k, v in dataclasses.asdict(mc).items()
            if not isinstance(v, dict)}
    (tmp_path / "configs" / "jamba2-mini-smoke.json").write_text(
        json.dumps({"name": "jamba2-mini-smoke",
                    "arch": "jamba2-mini-stage0", "smoke": True,
                    "source": "smoke size of the port's config",
                    "model": flat, "reduced": []}))
    mix = json.loads((H.BENCH / "traffic" / "longdoc.json").read_text())
    mix.update(slots=4, clients=4, capacity=96, pool=16,
               prompt={"median": 24, "p99": 80, "min": 8, "max": 80},
               output={"median": 8, "p99": 16, "min": 3, "max": 16},
               check={"min_tokens": 100})
    (tmp_path / "traffic" / "longdoc-tiny.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / f"{CELL}.json").write_text(
        json.dumps(LIMITS))
    man = lay.manifest()
    man["workloads"] = [{"name": CELL, "config": "jamba2-mini-smoke",
                         "traffic": "longdoc-tiny", "chips": 1,
                         "why": "CPU rehearsal"}]
    real = H.Layout().manifest()
    for m in real["end_to_end"] + real["per_layer"]:
        if FULL in m.get("workloads", [FULL]):
            mine = next((x for x in man["end_to_end"] + man["per_layer"]
                         if x["name"] == m["name"]), None)
            if mine is None:
                man["per_layer"].append(mine := dict(m))
            if "workloads" in m:
                mine["workloads"] = [CELL]
    lay.manifest_path.write_text(json.dumps(man))
    return lay


@pytest.mark.parametrize("trace", [0, 1])
def test_one_result_line(layout, capsys, trace):
    rc = run.main(["--workload", CELL, "--seed", str(2**33 + 5),
                   "--seconds", "3", "--trace", str(trace)], layout=layout,
                  device="cpu")
    cap = capsys.readouterr()
    assert rc == 0, cap.err[-2000:]
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] > 0
    names = set(out["metrics"])
    if trace:
        assert set(NEW) <= names
        for n in NEW:
            assert 0 < out["metrics"][n]["value"] < 100, n
    else:
        cell = H.resolve_cell(layout, CELL)
        assert names == {m["name"] for m, _ in cell.end_to_end} == {
            "serve_tok_per_s", "itl_p95_ms", "setup_s"}


def test_driver_is_the_serve_driver_with_this_models_parts(layout):
    cell = H.resolve_cell(layout, CELL)
    d = cell.driver
    assert d.serve.pb_weights.lm_weights is pb_jamba.weights
    assert d.serve.pb_peaks.lm_matmul_flops is pb_jamba.token_flops
    assert d.serve.pb_peaks.attention_flops is pb_jamba.attention_flops
    assert d.serve.ref.__name__.endswith("jamba")
    # set-up warms the pool's exact prompt lengths, the shapes the engine
    # prefills a recurrent stack at
    import pb_traffic
    assert d.buckets is d.serve.buckets is d.prompt_lengths
    assert d.buckets(cell.traffic) == sorted(set(pb_traffic.length_pool(
        cell.traffic["prompt"], cell.traffic["pool"]).tolist()))
    full = H.resolve_cell(H.Layout(), FULL).traffic
    assert d.buckets(full)[0] == 1012 and d.buckets(full)[-1] == 9322
    # the dense cells' driver keeps its own parts
    serve = layout.module("drivers", "serve")
    assert serve.pb_weights.__name__ == "pb_weights"
    assert serve.ref.__name__.endswith(".lm")


def test_work_counts_against_the_parameter_count():
    """A token's matmul FLOPs are twice the parameters it multiplies: the
    active ones less the embedding lookup, the norm gains and the Mamba
    mixers' leaves that are no matmul (conv, its bias, the time step's
    bias, ``A_log``, ``D``)."""
    from repro_torch.configs import get_config
    mc = get_config("jamba2-mini-stage0")
    d, s = mc.d_model, mc.ssm
    di = s.expand * d
    n_ssm = mc.layer_types().count("ssm")
    norms = mc.n_layers * 2 * d + d \
        + n_ssm * (s.dt_rank + 2 * s.state_dim)
    scan = n_ssm * (di * s.conv_width + di + di + di * s.state_dim + di)
    assert pb_jamba.token_flops(mc) // 2 == mc.active_param_count() \
        - mc.vocab * d - norms - scan
    assert pb_jamba.expert_bytes(mc) == 3 * 4096 * 14336 * 2
    assert pb_jamba.attention_flops(mc, 10) == 2 * 2 * 2 * 32 * 128 * 10
    assert pb_jamba.mixer_flops(mc, 3) == 2 * 3 * (
        4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096)
    mixer = dict(pb_jamba.weights(get_config("jamba2-mini-stage0",
                                             smoke=True), 1, "cpu")
                 ["unit"]["b0"]["ssm"])
    smoke = get_config("jamba2-mini-stage0", smoke=True)
    assert pb_jamba.mixer_weight_bytes(smoke) == sum(
        t[0].numel() * t.element_size() for t in mixer.values())


def test_weights_follow_the_seed_and_the_config():
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    mc = get_config("jamba2-mini-stage0", smoke=True)
    a, b = (pb_jamba.weights(mc, 2**40 + 1, "cpu") for _ in range(2))
    c = pb_jamba.weights(mc, 2**40 + 2, "cpu")
    assert torch.equal(a["unit"]["b1"]["moe"]["w_up"],
                       b["unit"]["b1"]["moe"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
    # the port's own tree, leaf for leaf, shape and dtype; the router as
    # published in bf16 (the port's own init draws it in float32)
    mine = LM(mc, device="cpu").init(torch.Generator().manual_seed(0))

    def spec(t, name=""):
        if isinstance(t, dict):
            return {k: spec(v, k) for k, v in t.items()}
        return (tuple(t.shape), None if name == "router" else t.dtype)
    assert spec(a) == spec(mine)
    assert a["unit"]["b1"]["moe"]["router"].dtype == torch.bfloat16
    dt = torch.nn.functional.softplus(a["unit"]["b0"]["ssm"]["dt_b"])
    assert 1e-3 * 0.999 <= dt.min() and dt.max() <= 0.1 * 1.001


def test_ssm_metrics_read_the_calls_of_their_phase(layout):
    """``ssm.prefill_roofline`` counts only the mixer calls inside a
    prefill (a decode call's span and shape are left out), each call's
    bound the larger of its FLOPs at the bf16 peak and its bytes at the
    HBM rate; the shares read the spans inside their phase."""
    roof = layout.module("metrics", "ssm.prefill_roofline")
    pre = layout.module("metrics", "ssm.prefill_share")
    dec = layout.module("metrics", "ssm.decode_share")
    rec = SimpleNamespace(
        spans={"@engine:_prefill_one": [(0.0, 1.0), (2.0, 3.0)],
               "@engine:_decode": [(4.0, 5.0)],
               roof.SSM_APPLY: [(0.1, 0.3), (2.1, 2.2), (4.1, 4.9)]},
        calls={roof.SSM_APPLY: [({}, (1, 1000, 4096), {}),
                                ({}, (1, 10, 4096), {}),
                                ({}, (16, 1, 4096), {})]},
        work={"ssm_mixer": {"flops_per_token": 2 * 10**8,
                            "weight_bytes": 2 * 10**8,
                            "row_bytes": 16384}})
    big = 1000 * 2e8 / 989e12
    small = (2e8 + 10 * 16384) / 3.35e12
    assert big > (2e8 + 1000 * 16384) / 3.35e12 and small > 10 * 2e8 / 989e12
    assert roof.read(rec) == pytest.approx(100 * (big + small) / 0.3)
    assert pre.read(rec) == pytest.approx(100 * 0.3 / 2.0)
    assert dec.read(rec) == pytest.approx(100 * 0.8 / 1.0)
    rec.calls = {}
    assert roof.read(rec) is None
    rec.spans = {"@engine:_prefill_one": [(0.0, 1.0)]}
    for mod in (roof, pre, dec):
        assert mod.read(rec) is None


def test_scan_kernel_roofline_reads_its_calls_and_device_time(layout):
    """``linear_scan_roofline``: each recorded chunk's decay, input and
    states at 4 bytes and its state before it, at the HBM rate, over the
    device time of the kernels named ``linear_scan_chunk``; nothing
    without a trace or a call."""
    mod = layout.module("metrics", "linear_scan_roofline")
    a, h = (1, 256, 8192, 16), (1, 8192, 16)
    rec = SimpleNamespace(
        calls={mod.CALLS[0]: [(a, a, h), ((1, 44, 8192, 16), a, h)]},
        trace={"per_name": {"linear_scan_chunk(float const*, ...)":
                            [2, 0.001],
                            "void at::native::elementwise": [9, 5.0]}})
    nbytes = 4 * (3 * (256 + 44) * 8192 * 16 + 2 * 8192 * 16)
    assert pb_jamba.scan_chunk_bytes(a, h) == 4 * (3 * 256 + 1) * 8192 * 16
    assert mod.read(rec) == pytest.approx(100 * nbytes / 3.35e12 / 0.001)
    rec.trace = None
    assert mod.read(rec) is None
    rec.trace, rec.calls = {"per_name": {}}, {}
    assert mod.read(rec) is None


def test_routing_flips_compares_every_served_position(layout):
    """On the experts the window routed each served position to, the
    reference's free run (choosing its own) and its run along them are
    compared at every served position; along them the gaps are the
    check's and the margins within its limit."""
    import routing_flips_hybrid
    out = routing_flips_hybrid.main(
        ["--workload", CELL, "--seed", str(2**33 + 5), "--seconds", "3",
         "--widest", "3"], layout=layout, device="cpu")
    assert out["requests"] > 0 and out["positions"] > out["requests"]
    parts = [out[f"{p}.{k}"] for p in ("prefill_last", "decoded")
             for k in ("differs", "same")]
    assert sum(x["free_gap"]["n"] for x in parts) == out["positions"]
    assert out["prefill_last.same"]["free_gap"]["n"] \
        + out["prefill_last.differs"]["free_gap"]["n"] == out["requests"]
    assert max(x["forced_gap"]["max"] for x in parts
               if x["forced_gap"]["n"]) <= LIMITS["served_logit_gap"]
    assert 0 < out["route_logit_margin"] <= LIMITS["route_logit_margin"]
    assert 0 < out["rerouted_decisions"] < out["routed_decisions"]
    assert out["decoded.same"]["margin"]["max"] == 0
    assert len(out["widest"]) == 3


def test_check_reads_along_the_served_experts(layout):
    """The window records each finished request's experts at each of its
    positions in each MoE layer; the reference along its own experts is
    its free run bit for bit; the program passes the check and the fp8
    control fails it."""
    from types import SimpleNamespace
    from reference import jamba as ref
    cell = H.resolve_cell(layout, CELL)
    mc = H.model_config(cell.config)
    ctx = SimpleNamespace(cfg=cell.config, mix=cell.traffic, seed=7,
                          device=torch.device("cpu"), sync=lambda: None,
                          model=mc, limits=cell.limits)
    st = cell.driver.setup(ctx)
    rec = SimpleNamespace(seconds=3, spans={}, calls={}, trace=None,
                          work={}, jobs=[])
    cell.driver.window(st, 3, rec)
    cell.driver.release(st)
    done = rec.work["done"]
    assert done
    layers = sum(mc.moe_at(i) for i in range(mc.n_layers))
    for req in done:
        got = rec.work["routes"][req.rid]
        assert len(got) == layers
        assert {tuple(r.shape) for r in got} == {
            (len(req.prompt) + len(req.out) - 1, mc.moe.top_k)}
    w = pb_jamba.weights(mc, 7, "cpu")
    seq = torch.as_tensor(list(done[0].prompt) + list(done[0].out))
    own = {}
    free = ref.forward(w, mc, seq, record=own)
    assert all(float(m.max()) == 0 for m in own["margin"])
    assert torch.equal(ref.forward(w, mc, seq, routes=own["routes"]), free)
    assert cell.driver.check(st, rec)["correct"] is True
    ctl = cell.driver.control(st, rec)
    assert ctl["correct"] is False
    assert set(ctl["compared"]) == set(LIMITS)
