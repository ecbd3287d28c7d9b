"""Share of the prefills' wall (``ServeEngine._prefill_one``, ended after
the device finished) spent in the Mamba mixers (``repro_torch.models.ssm:
ssm_apply``: projections, conv, the chunked scan and read-out; each call
ended after the device finished)."""

import pb_spans

UNIT = "%"
LAYER = "model"
SSM_APPLY = "repro_torch.models.ssm:ssm_apply"
SPANS = (pb_spans.SERVE_PREFILL, SSM_APPLY)


def read(rec):
    pre, inner = rec.spans.get(pb_spans.SERVE_PREFILL), rec.spans.get(
        SSM_APPLY)
    if not pre or not inner:
        return None
    return 100 * pb_spans.covered(pre, inner) / pb_spans.total(pre)
