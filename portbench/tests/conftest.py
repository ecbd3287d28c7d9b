"""Puts the benchmark's folder and the port's ``src`` on the path, and
gives the tests a throwaway layout of smoke-size cells."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


#: limits of the smoke cells, by the kind of cell, set as the committed
#: ones are: serve's above the program's largest reading (0.0241) and
#: below the fp8 control's smallest (0.223) over seeds 1-12 at 3 s on the
#: CPU; fabric exact
LIMITS = {"fabric": {"mismatched_outputs": 0},
          "serve": {"served_logit_gap": 0.08}}


def smoke_config(arch):
    from repro_torch.configs import get_config
    mc = get_config(arch, smoke=True)
    return {"name": f"{arch}-smoke", "arch": arch, "smoke": True,
            "source": "smoke size of the port's config",
            "model": {k: v for k, v in dataclasses.asdict(mc).items()
                      if v is not None}, "reduced": []}


def tiny_layout(tmp: Path, cells, extra=None):
    """A layout under ``tmp`` with smoke-size configs (``<arch>-smoke``),
    small mixes and the manifest's metrics, looked up before this
    folder's own files.  ``cells``: ``[(workload, config, traffic)]``;
    ``extra``: ``{relative path: text}`` further files."""
    import pb_harness as H

    for arch in ("qwen2-0.5b", "h2o-danube-1.8b"):
        (tmp / "configs").mkdir(parents=True, exist_ok=True)
        (tmp / "configs" / f"{arch}-smoke.json").write_text(
            json.dumps(smoke_config(arch)))
    (tmp / "traffic").mkdir(exist_ok=True)
    chat = json.loads((BENCH / "traffic" / "chat.json").read_text())
    # capacity within the smoke danube's 32-token window: a prefill
    # bucket past the window keeps the pads' keys and drops the prompt's
    # (the engine pads to powers of two; at full size the window is 4096
    # and the capacity 2048)
    chat.update(slots=4, clients=4, capacity=32, pool=64,
                prompt={"median": 8, "p99": 32, "min": 4, "max": 16},
                output={"median": 6, "p99": 20, "min": 3, "max": 16},
                check={"min_tokens": 100})
    (tmp / "traffic" / "chat-tiny.json").write_text(json.dumps(chat))
    (tmp / "limits").mkdir(exist_ok=True)
    man = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    work = []
    for name, cfg, mix in cells:
        work.append({"name": name, "config": cfg, "traffic": mix,
                     "chips": 1, "why": "CPU rehearsal"})
        (tmp / "limits" / f"{name}.json").write_text(
            json.dumps(LIMITS[name.split(".")[0]]))
    names = [w["name"] for w in work]
    for m in man["end_to_end"] + man["per_layer"]:
        kinds = {w.split(".")[0] for w in m.get("workloads", [])}
        if "workloads" in m:
            m["workloads"] = [n for n in names if n.split(".")[0] in kinds]
    man["workloads"] = work
    for rel, text in (extra or {}).items():
        p = tmp / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return H.Layout(manifest=tmp / "BENCHMARK.json", dirs=(tmp, BENCH))


@pytest.fixture
def layout(tmp_path):
    return tiny_layout(tmp_path, [
        ("fabric.qwen2-0.5b-smoke.w4a4", "qwen2-0.5b-smoke", "w4a4"),
        ("serve.h2o-danube-1.8b-smoke.chat-tiny", "h2o-danube-1.8b-smoke",
         "chat-tiny")])
