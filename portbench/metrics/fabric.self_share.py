"""Share of the fabric jobs' wall time spent outside the engine's
``execute_blocks`` launches: the PIM linear's quantize and unpack, the
fabric's schedule, pack, copies and consume (``pim/linear.py``,
``pim/fabric.py``)."""

import pb_spans

UNIT = "%"
LAYER = "PIM linear and fabric"
SPANS = (pb_spans.EXECUTE_BLOCKS,)


def read(rec):
    inner = rec.spans.get(pb_spans.EXECUTE_BLOCKS)
    if not inner or not rec.jobs:
        return None
    jobs = [(j["t0"], j["t1"]) for j in rec.jobs]
    total = sum(b - a for a, b in jobs)
    return 100 * (total - pb_spans.covered(jobs, inner)) / total
