"""``execute_blocks`` launches per model layer, over the window's whole
layers (every group of a layer run)."""

import pb_spans

UNIT = "count"
LAYER = "engine and compiler"
SPANS = (pb_spans.EXECUTE_BLOCKS,)


def read(rec):
    s = rec.spans.get(pb_spans.EXECUTE_BLOCKS)
    per = rec.work.get("jobs_per_layer")
    if not s or not per:
        return None
    whole = len(rec.jobs) // per * per
    if whole == 0:
        return None
    n = sum(pb_spans.count_within((j["t0"], j["t1"]), s)
            for j in rec.jobs[:whole])
    return n / (whole // per)
