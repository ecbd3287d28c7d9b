"""Each cell's control: the reference a precision below the stated one,
put in the program's place, goes through the driver's own ``check`` and
comes out not correct, while the program comes out correct.

At smoke size on the CPU, under limits set from smoke-size readings
(``conftest.LIMITS``); at each cell's own size on the card (``cuda``),
under the committed limits (``calibrate.py`` prints the same readings
over more seeds)."""

import json

import pytest

import calibrate
import pb_harness as H

CELLS = [("fabric.qwen2-0.5b-smoke.w4a4", "mismatched_outputs"),
         ("serve.h2o-danube-1.8b-smoke.chat-tiny", "served_logit_gap")]


@pytest.mark.parametrize("cell,number", CELLS)
def test_control_reads_above_the_program(layout, capsys, cell, number):
    # a serve window in which long requests finish on a loaded CPU too
    secs = "3.0" if cell.startswith("serve") else "0.3"
    assert calibrate.main(["--workload", cell, "--seeds", "1,2,3",
                           "--seconds", secs, "--control"],
                          layout=layout, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    low = max(x["program"][number] for x in lines[:-1])
    high = min(x["control"][number] for x in lines[:-1])
    assert high > 0 and high >= 3 * low


@pytest.mark.parametrize("cell,number", CELLS)
def test_control_is_not_correct_through_check(layout, cell, number):
    c = H.resolve_cell(layout, cell)
    secs = 3.0 if cell.startswith("serve") else 0.3
    for line in calibrate.readings(c, [1, 2, 3], secs, control=True,
                                   device="cpu"):
        assert line["program_correct"] is True, line
        assert line["control_correct"] is False, line
        assert line["control"][number] > c.limits[number]


#: (cell, window seconds): long enough to finish the mix's longest
#: requests (serve) or one whole layer (fabric)
FULL = [("fabric.qwen2-0.5b.w4a4", 5.0), ("serve.h2o-danube-1.8b.chat", 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,secs", FULL)
def test_control_fails_the_committed_limit_at_cell_size(cell, secs):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    c = H.resolve_cell(H.Layout(), cell)
    for line in calibrate.readings(c, [2**31 + 11, 2**32 + 15, 3**20],
                                   secs, control=True):
        print(json.dumps(line), flush=True)
        assert line["program_correct"] is True, line
        assert line["control_correct"] is False, line
