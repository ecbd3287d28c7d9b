"""95th percentile of the gaps between consecutive output tokens of one
request, over every token of every request in the window (a prefill in
a step lands in the gaps of every lane that waits for it)."""

import numpy as np

UNIT = "ms"
LAYER = "whole run"


def read(rec):
    gaps = rec.work["itl_s"]
    if not gaps:
        return None
    return 1e3 * float(np.percentile(np.asarray(gaps), 95))
