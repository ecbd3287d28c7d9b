"""CPU rehearsals of the program's own spans and counters: a window of
each smoke cell under ``program_trace.py`` gives every reading of
``pb_program.READERS`` and a correct verdict, its clock check pairs each
span with its ``record_function`` range, and ``run.py``'s untraced line
keeps its keys and leaves the recorder off."""

import json
import re

import pytest

import pb_program
import program_trace
import run
from test_portbench_rehearsal import FABRIC, KEYS, SERVE, SERVE_SECONDS


def window(layout, capsys, cell, *extra, seed=2**31 + 23):
    out = program_trace.main(
        ["--workload", cell, "--seed", str(seed), "--seconds",
         str(SERVE_SECONDS if cell == SERVE else 0.3), *extra],
        layout=layout, device="cpu")
    return out, capsys.readouterr().err


@pytest.mark.parametrize("cell", [FABRIC, SERVE])
def test_window_gives_every_program_reading(layout, capsys, cell):
    from repro_torch import trace

    out, err = window(layout, capsys, cell)
    assert out["correct"] is True
    kind = cell.split(".")[0]
    m = out["readings"]
    assert set(pb_program.READERS[kind]) <= set(m)
    if kind == "fabric":
        # the compiles the fabric window itself prints
        said = re.search(r"compiles in the window: (\d+)", err)
        assert m["engine.compile_misses"] == int(said.group(1))
        assert 0 <= m["fabric.pad_share"] < 100
        assert 0 < m["fabric.pack_share"] < 100
        assert 0 <= m["fabric.rest_share"] < 100
    else:
        assert 0 < m["serve.prefill_pad_share"] < 100
        assert 0 < m["model.attention_share"] < 100
    assert trace.span("x") is trace.NULL       # the recorder is off


@pytest.mark.parametrize("cell", [FABRIC, SERVE])
def test_untraced_run_keeps_its_line_and_records_nothing(layout, capsys,
                                                         cell):
    from repro_torch import trace

    rc = run.main(["--workload", cell, "--seed", str(2**31 + 23),
                   "--seconds", str(SERVE_SECONDS if cell == SERVE else 0.3),
                   "--trace", "0"], layout=layout, device="cpu")
    cap = capsys.readouterr()
    assert rc == 0, cap.err[-2000:]
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert list(out) == KEYS + ["compared"]
    assert set(out["metrics"]) == {
        m["name"] for m, _ in run.H.resolve_cell(layout, cell).end_to_end}
    assert trace.span("x") is trace.NULL and trace.take() == ([], {})


@pytest.mark.parametrize("cell", [FABRIC, SERVE])
def test_clock_check_pairs_each_span_with_its_range(layout, capsys, cell):
    from repro_torch import trace

    out, _ = window(layout, capsys, cell, "--clock", seed=2**31 + 29)
    assert out["correct"] is True
    assert out["clock"] == "realtime" and out["spans"] > 0
    assert out["ranges"] == out["spans"]
    for name, n in out["by_name"].items():
        assert n["spans"] == n["ranges"], name
    # a loaded host can deschedule the thread between the two stamps
    assert 0 <= out["gap"]["median_us"] < 1000
    assert trace.span("x") is trace.NULL
