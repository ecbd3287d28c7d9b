"""Mean share of the engine's slots holding a request, read from
``engine.slots`` after each ``step()`` of the window."""

UNIT = "%"
LAYER = "serve engine"


def read(rec):
    occ = rec.work.get("occupancy")
    if not occ:
        return None
    return 100 * sum(occ) / len(occ)
