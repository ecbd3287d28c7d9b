"""Readers of the program's own spans and counters (``repro_torch.trace``).

Each reader takes a record of one window, as ``program_trace.py`` makes
it: ``rec.spans`` (span name -> ``[(t0, t1)]`` on ``time.perf_counter``),
``rec.jobs`` (the fabric driver's jobs, with their ``t0`` and ``t1``)
and ``rec.counters``, the recorder's counters and ``"@<root>:<key>"``,
the window's change in ``stats[key]`` of the object the driver names
``root``.  A reader returns None where its spans or counters were not
recorded.  Shares are of the fabric jobs' wall unless said otherwise.
"""

import bisect

import pb_spans

#: name prefixes of the program's spans (``repro_torch.trace``)
PROGRAM_PREFIXES = ("pim.", "fabric.", "engine.", "serve.", "model.")


def jobs_share(rec, names):
    """Share (%) of the jobs' wall that the spans ``names`` cover, or
    None where none of them was recorded."""
    spans = [s for n in names for s in rec.spans.get(n, ())]
    if not spans or not rec.jobs:
        return None
    jobs = [(j["t0"], j["t1"]) for j in rec.jobs]
    return 100 * pb_spans.covered(jobs, spans) / pb_spans.total(jobs)


def time_inside(inner, outer) -> float:
    """Seconds of the ``inner`` spans that lie inside one of the
    ``outer`` spans (neither list overlaps itself)."""
    outer = sorted(outer)
    starts = [a for a, _ in outer]
    t = 0.0
    for a, b in inner:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= outer[i][1]:
            t += b - a
    return t


def pad_share(rec):
    """Share of the launched blocks that hold no task: 1 - the task
    slots the fabric packed (``fabric.slots_used``) over the blocks the
    compiled engine launched after ``canonical_block_budget`` padded each
    launch (``engine.blocks_launched``)."""
    used = rec.counters.get("fabric.slots_used")
    launched = rec.counters.get("engine.blocks_launched")
    if used is None or not launched:
        return None
    return 100 * (1 - used / launched)


def prefill_pad_share(rec):
    """Share of the prefilled tokens that are padding: each prefill's
    power-of-two bucket less its chunk (``serve.prefill_padded_tokens``)
    over it plus the prompt tokens prefilled in the window
    (``ServeEngine.stats["prefill_tokens"]``)."""
    pad = rec.counters.get("serve.prefill_padded_tokens")
    real = rec.counters.get("@engine:prefill_tokens")
    if pad is None or real is None or pad + real == 0:
        return None
    return 100 * pad / (pad + real)


def attention_share(rec):
    """Share of the decode steps' time in the model's attention blocks:
    ``model.attention`` inside ``serve.decode``, over ``serve.decode``
    (the model call, the sample and its ``.cpu()``)."""
    dec = rec.spans.get("serve.decode")
    if not dec:
        return None
    att = rec.spans.get("model.attention", ())
    return 100 * time_inside(att, dec) / pb_spans.total(dec)


#: the per-layer readings by the driver of the cell they read, under the
#: metric names ``PERF.md`` gives them
READERS = {
    "fabric": {
        # the PIM linear's own phases: activations quantized and copied
        # to the host, packed weights unpacked, accumulators scaled back
        "pim.linear_share": lambda rec: jobs_share(
            rec, ("pim.quantize", "pim.unpack_weights", "pim.dequant")),
        # the plan and its cost, made again by every job
        "fabric.schedule_share": lambda rec: jobs_share(
            rec, ("fabric.schedule", "fabric.cost")),
        # operands encoded and the block images packed in numpy
        "fabric.pack_share": lambda rec: jobs_share(
            rec, ("fabric.encode", "fabric.pack")),
        # the images' copies; ``fabric.d2h`` also waits for the kernels
        "fabric.copy_share": lambda rec: jobs_share(
            rec, ("fabric.h2d", "fabric.d2h")),
        "fabric.consume_share": lambda rec: jobs_share(
            rec, ("fabric.consume", "fabric.unbias")),
        # the engine's launches, host side
        "engine.launch_share": lambda rec: jobs_share(
            rec, ("engine.execute_blocks",)),
        "fabric.pad_share": pad_share,
        "engine.compile_misses": lambda rec: rec.counters.get(
            "engine.compile_misses"),
    },
    "serve": {
        "serve.prefill_pad_share": prefill_pad_share,
        "model.attention_share": attention_share,
    },
}


def labelled_share(idle_by_span) -> float | None:
    """Share (%) of the idle seconds (``reduce_trace``'s
    ``idle_by_span``) that a program span labels."""
    idle = sum(idle_by_span.values())
    if not idle:
        return None
    mine = sum(v for n, v in idle_by_span.items()
               if n.startswith(PROGRAM_PREFIXES))
    return 100 * mine / idle
