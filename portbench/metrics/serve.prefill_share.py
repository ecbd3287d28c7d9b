"""Share of the window spent in the engine's prefill callable
(``ServeEngine._prefill_one``: ``LM.prefill`` at a padded bucket, ended
after the device finished)."""

import pb_spans

UNIT = "%"
LAYER = "serve engine"
SPANS = (pb_spans.SERVE_PREFILL,)


def read(rec):
    s = rec.spans.get(pb_spans.SERVE_PREFILL)
    if not s:
        return None
    return 100 * pb_spans.total(s) / rec.window_s
