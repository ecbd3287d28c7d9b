"""CPU rehearsals of whole runs at smoke size: the result line, the exit
without a card, and ``correct`` coming out false when the timed path is
broken underneath (an answer or a token altered where it is produced,
half the batch left out, a decode step that returns its cache
unchanged)."""

import json

import pytest
import torch

import run

FABRIC = "fabric.qwen2-0.5b-smoke.w4a4"
SERVE = "serve.h2o-danube-1.8b-smoke.chat-tiny"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
#: a serve window in which requests finish on a loaded CPU too
SERVE_SECONDS = 3.0


def result(layout, capsys, cell, trace=0, seconds=0.3, seed=2**31 + 11):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], layout=layout,
                  device="cpu")
    cap = capsys.readouterr()
    assert rc == 0, cap.err[-2000:]
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err


@pytest.mark.parametrize("cell", [FABRIC, SERVE])
@pytest.mark.parametrize("trace", [0, 1])
def test_one_result_line(layout, capsys, cell, trace):
    out, err = result(layout, capsys, cell, trace,
                      seconds=SERVE_SECONDS if cell == SERVE else 0.3)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert set(keys) <= set(KEYS) | {"breakdown", "compared"}
    assert out["correct"] is True and out["attempted"] > 0
    assert out["failed"] == 0
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    if trace == 0:
        assert "setup_s" in out["metrics"]
    # the compared numbers close standard error, each beside its limit
    last = err.strip().splitlines()[-len(out["compared"]):]
    for line, (k, v) in zip(last, out["compared"].items()):
        assert line == f"{k} {v['value']!r} limit {v['limit']!r}"


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "fabric.qwen2-0.5b.w4a4", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == ""


def altered_fabric(monkeypatch, how):
    from repro_torch.pim import linear as pl
    orig = pl.fused_linear_apply

    def broken(params_list, x, cfg):
        outs = orig(params_list, x, cfg)
        if how == "answer":            # one element off where produced
            y = outs[0].clone()
            y[0, 0] = y[0, 0] * 2 + 1
            return (y,) + tuple(outs[1:])
        # half the rows left out: the kept half's product, the rest its mean
        half = x.shape[0] // 2
        kept = orig(params_list, x[:half], cfg)
        return tuple(torch.cat([k, k.mean(0, keepdim=True).expand(
            x.shape[0] - half, -1).to(k.dtype)]) for k in kept)

    monkeypatch.setattr(pl, "fused_linear_apply", broken)


@pytest.mark.parametrize("how", ["answer", "half_batch"])
def test_fabric_fault_is_not_correct(layout, capsys, monkeypatch, how):
    altered_fabric(monkeypatch, how)
    out, _ = result(layout, capsys, FABRIC)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["mismatched_outputs"]["value"] > 0


def broken_engine(monkeypatch, how):
    from repro_torch.serve import engine as se
    orig_init = se.ServeEngine.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        decode = self._decode
        steps = []

        def step(params, caches, tokens, pos):
            logits, new = decode(params, caches, tokens, pos)
            steps.append(1)
            if how == "state":          # the caches come back unchanged
                return logits, caches
            if len(steps) >= 5:         # tokens altered where produced
                logits = logits.clone()
                logits[:, 0, 7] = logits.max() + 50
            return logits, new

        self._decode = step

    monkeypatch.setattr(se.ServeEngine, "__init__", init)


@pytest.mark.parametrize("how", ["token", "state"])
def test_serve_fault_is_not_correct(layout, capsys, monkeypatch, how):
    broken_engine(monkeypatch, how)
    out, _ = result(layout, capsys, SERVE, seconds=SERVE_SECONDS)
    assert out["correct"] is False
    assert out["compared"]["served_logit_gap"]["value"] > \
        out["compared"]["served_logit_gap"]["limit"]
