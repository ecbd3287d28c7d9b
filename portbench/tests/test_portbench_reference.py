"""The plain references against the port at smoke size on the CPU, and
their controls a precision below: the test may import both, the
references import nothing of the port."""

import json

import numpy as np
import pytest
import torch

import pb_traffic
import pb_weights
from conftest import BENCH, smoke_config
from reference import fabric as rf
from reference import lm as rl


@pytest.mark.parametrize("bits", [(4, 4), (4, 8), (8, 8)])
@pytest.mark.parametrize("shape", [(8, 64, 96), (3, 256, 40)])
def test_fabric_reference_is_the_port_bit_for_bit(bits, shape):
    from repro_torch.pim import linear as pl
    wb, ab = bits
    m, k, n = shape
    g = torch.Generator().manual_seed(k * n + wb + ab)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g) * k ** -0.5).to(torch.bfloat16)
    want = rf.linear(x, w, wb, ab)
    for mode in ("ref", "fabric"):
        cfg = pl.PimConfig(mode=mode, weight_bits=wb, act_bits=ab)
        p = pl.pack_linear({"w": w}, cfg)
        got = pl.fused_linear_apply([p], x, cfg)[0]
        assert rf.mismatches(got, want) == 0, mode


@pytest.mark.parametrize("bits", [(4, 4), (4, 8)])
def test_fabric_control_fails_the_exact_comparison(bits):
    """The control (a bf16 GEMM of the dequantized codes at W4A4, 4-bit
    activations at W4A8) misses the reference's bit patterns."""
    wb, ab = bits
    g = torch.Generator().manual_seed(3)
    x = torch.randn((8, 896), generator=g).to(torch.bfloat16)
    w = (torch.randn((896, 128), generator=g) * 896 ** -0.5).to(
        torch.bfloat16)
    assert rf.mismatches(rf.control(x, w, wb, ab),
                         rf.linear(x, w, wb, ab)) > 0


def port_logits(mc, params, tokens):
    from repro_torch.models.model import LM
    model = LM(mc, device="cpu")
    logits, _ = model.apply(params, tokens=tokens[None])
    return logits[0].to(torch.float32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b"])
def test_lm_reference_against_the_port(arch):
    """float32 reference logits against the port's bf16 forward on the
    same weights, over a sequence longer than the smoke danube's window
    (32); the fp8 control lies farther from the reference than the port."""
    from repro_torch.configs import get_config
    mc = get_config(arch, smoke=True)
    w = pb_weights.lm_weights(mc, 11, "cpu")
    tokens = torch.as_tensor(
        np.random.default_rng(2).integers(0, mc.vocab, 48), dtype=torch.int32)
    want = rl.forward(w, mc, tokens)
    got = port_logits(mc, w, tokens)
    # the port computes in bf16 and rounds its logits to bf16: 0.045
    # (qwen2) and 0.057 (danube) at this size against logits of unit
    # spread; the fp8 control lies 0.6-0.85 off
    port_err = (got - want).abs().max().item()
    assert port_err < 0.1
    ctl_err = (rl.forward(w, mc, tokens, quant="fp8") - want).abs().max()
    assert ctl_err.item() > 3 * port_err


def test_served_gaps():
    logits = torch.tensor([[0.0, 1.0, 0.5], [2.0, 0.0, 1.5], [0.0, 0.0, 3.0]])
    # prompt of 2: the served tokens follow positions 1 and 2
    assert rl.served_gaps(logits, 2, [2, 2]) == [0.5, 0.0]


def test_weights_follow_the_seed_and_the_config():
    from repro_torch.configs import get_config
    mc = get_config("qwen2-0.5b", smoke=True)
    a, b = (pb_weights.lm_weights(mc, 2**40 + 1, "cpu") for _ in range(2))
    c = pb_weights.lm_weights(mc, 2**40 + 2, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["unit"]["b0"]["attn"]["wq"].shape == (
        mc.n_layers, mc.d_model, mc.n_heads, mc.hd)
    assert "head" not in a and smoke_config("qwen2-0.5b")["smoke"]


def test_a_lognormal_through_its_median_and_99th_percentile():
    pool = pb_traffic.length_pool(
        {"median": 256, "p99": 1536, "min": 1, "max": 10**6}, 1000)
    assert abs(np.median(pool) - 256) <= 2
    assert abs(np.quantile(pool, 0.99) - 1536) <= 0.02 * 1536
    # the committed chat pool holds both upper clips
    mix = json.loads((BENCH / "traffic" / "chat.json").read_text())
    for part in ("prompt", "output"):
        pool = pb_traffic.length_pool(mix[part], mix["pool"])
        assert pool.max() == mix[part]["max"]


def test_traffic_changes_order_not_work():
    spec = {"median": 256, "p99": 1536, "min": 32, "max": 1536}
    pool = pb_traffic.length_pool(spec, 1024)
    assert pool.min() >= 32 and pool.max() <= 1536
    assert abs(np.median(pool) - 256) <= 2
    mix = {"pool": 64, "prompt": spec,
           "output": {"median": 48, "p99": 256, "min": 16, "max": 256}}
    a = pb_traffic.requests(mix, 2**33 + 5, 32000)
    b = pb_traffic.requests(mix, 7, 32000)
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(o for _, o in a) == sorted(o for _, o in b)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert all(p.max() < 32000 and p.dtype == np.int32 for p, _ in a)
