"""Share of the decode steps' wall (``ServeEngine._decode``, ended after
the device finished) spent in the latent attention's decode
(``repro_torch.models.mla:mla_decode``, each call ended after the device
finished)."""

import pb_spans

UNIT = "%"
LAYER = "model"
MLA_DECODE = "repro_torch.models.mla:mla_decode"
SPANS = (pb_spans.SERVE_DECODE, MLA_DECODE)


def read(rec):
    dec, inner = rec.spans.get(pb_spans.SERVE_DECODE), rec.spans.get(
        MLA_DECODE)
    if not dec or not inner:
        return None
    return 100 * pb_spans.covered(dec, inner) / pb_spans.total(dec)
