"""The manifest: every cell resolves its files by name, the entries keep
the benchmark's contract, and a new cell is new files and entries only."""

import json
import re

import pytest

import pb_harness as H
import run
from conftest import BENCH, tiny_layout

MAN = json.loads((H.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((H.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_every_file_by_name(cell):
    c = H.resolve_cell(H.Layout(), cell)
    assert c.chips == 1
    for fn in ("setup", "roots", "window", "release", "check", "control"):
        assert callable(getattr(c.driver, fn))
    assert c.end_to_end and c.per_layer
    names = {m["name"] for m, _ in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m, mod in c.end_to_end + c.per_layer:
        assert callable(mod.read) and isinstance(mod.UNIT, str)
        assert mod.UNIT == m["unit"]
    # every per-layer metric moves an end-to-end metric this cell reports
    for m, _ in c.per_layer:
        assert m["moves"] in names
    assert H.model_config(c.config).name == c.config["arch"]
    assert c.limits


def test_entries_keep_the_contract():
    seen = set()
    cfg_names = {c["name"] for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert cfg_names == used
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((H.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank")) and k not in (
                "d_model", "d_ff", "n_heads", "n_kv_heads", "head_dim")
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] \
            + MAN["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert m["name"] not in seen
        seen.add(m["name"])
        if "unit" in m:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        for w in m.get("workloads", []):
            assert w in CELLS


def test_a_new_cell_is_new_files_and_entries(tmp_path, capsys):
    """A throwaway configuration, mix, metric and cell, added as files in
    another folder and entries in a copy of the manifest, resolve and run
    with no edit to any file of the benchmark."""
    before = {p: p.read_bytes() for p in BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    metric = ('"""Jobs per second."""\nUNIT = "jobs/s"\nLAYER = "whole'
              ' run"\n\n\ndef read(rec):\n    return len(rec.jobs) / '
              'rec.window_s\n')
    mix = json.loads((BENCH / "traffic" / "w4a4.json").read_text())
    mix["rows"] = 3
    lay = tiny_layout(tmp_path, [("fabric.qwen2-0.5b-smoke.rows3",
                                  "qwen2-0.5b-smoke", "rows3")],
                      extra={"metrics/jobs_per_s.py": metric,
                             "traffic/rows3.json": json.dumps(mix)})
    man = lay.manifest()
    man["end_to_end"].append({"name": "jobs_per_s", "unit": "jobs/s",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["fabric.qwen2-0.5b-smoke.rows3"]})
    lay.manifest_path.write_text(json.dumps(man))
    assert run.main(["--workload", "fabric.qwen2-0.5b-smoke.rows3",
                     "--seed", "7", "--seconds", "0.2", "--trace", "0"],
                    layout=lay, device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert {"jobs_per_s", "fabric_mac_per_s", "setup_s"} <= set(
        out["metrics"])
    after = {p: p.read_bytes() for p in BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


@pytest.mark.parametrize("cfg", [c["name"] for c in MAN["configs"]])
def test_config_runs_as_its_file_states(cfg):
    """Every value of the file's ``model`` is the one run, the published
    ones included; a shape that differs from the port's config fails."""
    import dataclasses

    f = json.loads((BENCH / "configs" / f"{cfg}.json").read_text())
    mc = dataclasses.asdict(H.model_config(f))
    assert {k: mc[k] for k in f["model"]} == f["model"]
    pub = f["published"]
    assert mc["rope_theta"] == pub["rope_theta"]
    assert mc["norm_eps"] == pub["rms_norm_eps"]
    assert (mc["d_model"], mc["d_ff"], mc["vocab"]) == (
        pub["hidden_size"], pub["intermediate_size"], pub["vocab_size"])
    bad = dict(f, model=dict(f["model"], d_ff=f["model"]["d_ff"] + 64))
    with pytest.raises(ValueError, match="d_ff"):
        H.model_config(bad)
