"""Targets of the spans the metrics read, and interval arithmetic on
spans (``[(t0, t1), ...]`` on ``time.perf_counter``)."""

#: the engine's wide-block launch, which the fabric calls through the
#: module attribute (``engine.execute_blocks``)
EXECUTE_BLOCKS = "repro_torch.core.engine:execute_blocks"
#: the serve engine's prefill and decode callables (instance attributes
#: of the cell's ``ServeEngine``, named ``engine`` by the driver)
SERVE_PREFILL = "@engine:_prefill_one"
SERVE_DECODE = "@engine:_decode"


def merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(outer, inner) -> float:
    """Seconds of ``outer`` that ``inner`` covers (each merged first)."""
    inner = merged(inner)
    total = 0.0
    for a, b in merged(outer):
        for c, d in inner:
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                total += hi - lo
    return total


def count_within(interval, spans) -> int:
    a, b = interval
    return sum(1 for c, d in spans if c >= a and d <= b)


def total(spans) -> float:
    return sum(b - a for a, b in spans)
