"""The MoE FFN's share of its byte roofline in the decode steps: the
least time to read once, at the HBM rate, the weights of the experts
each decode call routed rows to (the port's device counter
``moe.decode_expert_hits``: per layer and expert, the decode calls that
gave it a row) and the routed rows in and out, over the wall of those
calls (``moe_apply`` inside ``ServeEngine._decode``, each ended after the
device finished).  A decode call is bound by these bytes: its 96 rows
(16 lanes, top-6) meet some 0.9 GB of expert weights."""

import bisect

import pb_peaks
import pb_spans

UNIT = "%"
LAYER = "model"
MOE_APPLY = "repro_torch.models.moe:moe_apply"
SPANS = (pb_spans.SERVE_DECODE, MOE_APPLY)


def read(rec):
    hits = rec.work.get("device_counters", {}).get("moe.decode_expert_hits")
    dec, calls = rec.spans.get(pb_spans.SERVE_DECODE), rec.spans.get(
        MOE_APPLY)
    if hits is None or not dec or not calls:
        return None
    dec = sorted(dec)
    starts = [a for a, _ in dec]

    def in_decode(c):
        i = bisect.bisect_right(starts, c[0]) - 1
        return i >= 0 and c[1] <= dec[i][1]

    inside = [c for c in calls if in_decode(c)]
    wall = pb_spans.total(inside)
    if wall <= 0:
        return None
    m = rec.work["moe_decode"]
    rows = len(inside) * m["rows_per_call"]
    nbytes = int(hits.sum()) * m["expert_bytes"] + 2 * rows * m["row_bytes"]
    return 100 * pb_peaks.bound_s(nbytes=nbytes) / wall
