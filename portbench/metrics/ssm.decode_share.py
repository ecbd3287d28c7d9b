"""Share of the decode steps' wall (``ServeEngine._decode``, ended after
the device finished) spent in the Mamba mixers (``repro_torch.models.ssm:
ssm_apply``: projections, conv, scan and read-out, the state's update;
each call ended after the device finished)."""

import pb_spans

UNIT = "%"
LAYER = "model"
SSM_APPLY = "repro_torch.models.ssm:ssm_apply"
SPANS = (pb_spans.SERVE_DECODE, SSM_APPLY)


def read(rec):
    dec, inner = rec.spans.get(pb_spans.SERVE_DECODE), rec.spans.get(
        SSM_APPLY)
    if not dec or not inner:
        return None
    return 100 * pb_spans.covered(dec, inner) / pb_spans.total(dec)
