"""Mean wall of one decode step of the model (``LM.decode_step`` as the
engine calls it, over every slot, ended after the device finished)."""

import pb_spans

UNIT = "ms"
LAYER = "model"
SPANS = (pb_spans.SERVE_DECODE,)


def read(rec):
    s = rec.spans.get(pb_spans.SERVE_DECODE)
    if not s:
        return None
    return 1e3 * pb_spans.total(s) / len(s)
