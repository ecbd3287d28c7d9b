"""The latent-attention MoE serve cell (``drivers/serve_mla_moe.py``) at
smoke size on the CPU: a whole run's result line with its new per-layer
metrics, that module as the serve cells' module with this model's parts
swapped in, and the work counts of ``pb_mla_moe`` against the config's
parameter count."""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

import pb_harness as H
import pb_mla_moe
import run
from conftest import tiny_layout

CELL = "serve.deepseek-v2-lite-smoke.docqa-tiny"
FULL = "serve.deepseek-v2-lite.docqa"
NEW = ("mla.decode_share", "moe.decode_share", "moe.byte_roofline")
#: the smoke deepseek's 3 of 8 experts, gates near 0.17, flip on router
#: ties in bf16: its program read up to 0.317 and its fp8 control from
#: 0.519 over seeds 1-6 at 4 s on the CPU
LIMIT = 0.45


@pytest.fixture
def layout(tmp_path):
    from repro_torch.configs import get_config
    lay = tiny_layout(tmp_path, [])
    mc = get_config("deepseek-v2-lite", smoke=True)
    flat = {k: v for k, v in dataclasses.asdict(mc).items()
            if v is not None and not isinstance(v, dict)}
    (tmp_path / "configs" / "deepseek-v2-lite-smoke.json").write_text(
        json.dumps({"name": "deepseek-v2-lite-smoke",
                    "arch": "deepseek-v2-lite", "smoke": True,
                    "source": "smoke size of the port's config",
                    "model": flat, "reduced": []}))
    mix = json.loads((H.BENCH / "traffic" / "docqa.json").read_text())
    mix.update(slots=4, clients=4, capacity=64, pool=24,
               prompt={"median": 16, "p99": 48, "min": 8, "max": 48},
               output={"median": 6, "p99": 16, "min": 3, "max": 16},
               check={"min_tokens": 100})
    (tmp_path / "traffic" / "docqa-tiny.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / f"{CELL}.json").write_text(
        json.dumps({"served_logit_gap": LIMIT}))
    man = lay.manifest()
    man["workloads"] = [{"name": CELL, "config": "deepseek-v2-lite-smoke",
                         "traffic": "docqa-tiny", "chips": 1,
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
        assert set(NEW) <= names and "decode_step_ms" in names
        for n in NEW:
            assert 0 < out["metrics"][n]["value"] < 100
    else:
        assert {"serve_tok_per_s", "itl_p95_ms", "setup_s"} <= names


def test_driver_is_the_serve_driver_with_this_models_parts(layout):
    cell = H.resolve_cell(layout, CELL)
    d = cell.driver
    assert d.serve.pb_weights.lm_weights is pb_mla_moe.weights
    assert d.serve.pb_peaks.lm_matmul_flops is pb_mla_moe.token_flops
    assert d.serve.ref.__name__.endswith("deepseek_v2")
    # the dense cells' driver keeps its own parts
    serve = layout.module("drivers", "serve")
    assert serve.pb_weights.__name__ == "pb_weights"
    assert serve.ref.__name__.endswith(".lm")


def test_work_counts_against_the_parameter_count():
    """A token's matmul FLOPs are twice the parameters it multiplies: the
    active ones less the embedding lookup and the norm gains."""
    from repro_torch.configs import get_config
    mc = get_config("deepseek-v2-lite")
    norms = mc.n_layers * (2 * mc.d_model + mc.mla.kv_lora_rank) \
        + mc.d_model
    assert pb_mla_moe.token_flops(mc) // 2 == mc.active_param_count() \
        - mc.vocab * mc.d_model - norms
    assert pb_mla_moe.expert_bytes(mc) == 3 * 2048 * 1408 * 2
    assert pb_mla_moe.attention_flops(mc, 10) == 2 * 27 * 16 * 320 * 10


def test_weights_follow_the_seed_and_the_config():
    from repro_torch.configs import get_config
    mc = get_config("deepseek-v2-lite", smoke=True)
    a, b = (pb_mla_moe.weights(mc, 2**40 + 1, "cpu") for _ in range(2))
    c = pb_mla_moe.weights(mc, 2**40 + 2, "cpu")
    assert torch.equal(a["unit"]["b0"]["moe"]["w_up"],
                       b["unit"]["b0"]["moe"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
    e = a["unit"]["b0"]["moe"]
    assert e["w_gate"].shape == (mc.n_layers - 1, 8, mc.d_model, 32)
    assert e["shared"]["w_down"].shape == (mc.n_layers - 1, 64, mc.d_model)
    assert len(a["lead"]) == 1 and a["lead"][0]["mlp"]["w_up"].shape == (
        mc.d_model, mc.d_ff)
    assert a["lead"][0]["ln1"].dtype == torch.float32


def test_byte_roofline_reads_decode_calls_only(layout):
    mod = layout.module("metrics", "moe.byte_roofline")
    rec = SimpleNamespace(
        spans={"@engine:_decode": [(0.0, 1.0), (2.0, 3.0)],
               mod.MOE_APPLY: [(0.1, 0.3), (2.1, 2.3), (5.0, 9.0)]},
        work={"device_counters": {"moe.decode_expert_hits":
                                  torch.tensor([[3, 0], [2, 5]])},
              "moe_decode": {"expert_bytes": 10**9, "row_bytes": 4096,
                             "rows_per_call": 96}})
    nbytes = 10 * 10**9 + 2 * 2 * 96 * 4096
    want = 100 * nbytes / 3.35e12 / 0.4
    assert mod.read(rec) == pytest.approx(want)
    rec.work = {}
    assert mod.read(rec) is None


def test_soak_keeps_one_loop_over_windows(layout):
    import soak
    lines = soak.main(["--workload", CELL, "--seed", str(2**33 + 1),
                       "--seconds", "1", "--windows", "2"], layout=layout,
                      device="cpu")
    assert [x["window"] for x in lines] == [0, 1]
    for x in lines:
        assert x["tok_per_s"] > 0 and x["decode_steps"] > 0
        assert x["decode_ms_median"] > 0 and x["rss_bytes"] > 0


def test_routing_flips_compares_every_served_position(layout):
    """Replayed at batch 1, the port puts first the token the engine
    served; each position's routing is compared layer by layer."""
    import routing_flips
    out = routing_flips.main(["--workload", CELL, "--seed",
                              str(2**33 + 5), "--seconds", "2",
                              "--widest", "3"], layout=layout,
                             device="cpu")
    assert out["requests"] > 0 and out["positions"] >= 100
    assert out["replay_agrees"] > 0.9
    parts = [out[f"{p}.{k}"]["served_gap"]["n"]
             for p in ("prefill_last", "decoded")
             for k in ("differs", "same")]
    assert sum(parts) == out["positions"]
    assert out["prefill_last.same"]["served_gap"]["n"] \
        + out["prefill_last.differs"]["served_gap"]["n"] == out["requests"]
    for part in ("prefill_last", "decoded"):
        for k in ("differs", "same"):
            got = out[f"{part}.{k}"]
            assert got["forced_error"]["n"] == got["served_gap"]["n"]
    assert len(out["widest"]) == 3
