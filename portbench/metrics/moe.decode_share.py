"""Share of the decode steps' wall (``ServeEngine._decode``, ended after
the device finished) spent in the MoE FFN (``repro_torch.models.moe:
moe_apply``: routing, routed and shared experts, combine; each call ended
after the device finished)."""

import pb_spans

UNIT = "%"
LAYER = "model"
MOE_APPLY = "repro_torch.models.moe:moe_apply"
SPANS = (pb_spans.SERVE_DECODE, MOE_APPLY)


def read(rec):
    dec, inner = rec.spans.get(pb_spans.SERVE_DECODE), rec.spans.get(
        MOE_APPLY)
    if not dec or not inner:
        return None
    return 100 * pb_spans.covered(dec, inner) / pb_spans.total(dec)
