"""Mean wall of one ``execute_blocks`` launch (the engine's compiled
round on a wide block, ended after the device finished; ``core/engine.py``,
``core/compiler.py``)."""

import pb_spans

UNIT = "ms"
LAYER = "engine and compiler"
SPANS = (pb_spans.EXECUTE_BLOCKS,)


def read(rec):
    s = rec.spans.get(pb_spans.EXECUTE_BLOCKS)
    if not s:
        return None
    return 1e3 * sum(b - a for a, b in s) / len(s)
