"""Spans and counters inside the port, recorded in memory.

The port's layers mark their phases with ``span`` and count their work
with ``count``; both cost one call and nothing else until a caller turns
the recorder on::

    from repro_torch import trace

    trace.enable()                    # or enable(annotate=True)
    ...                               # run the program
    spans, counters = trace.take()    # the record, cleared
    trace.disable()

A span is ``(name, t0_ns, t1_ns, parent, tags)``: its name, its start
and end on ``time.perf_counter_ns``, the index in ``spans`` of the span
it ran inside (``None`` at the top) and the keyword tags it was opened
with.  A counter is a name and a sum.  ``take`` adds
``engine.compile_misses``: the engine's compile-cache misses since
``enable`` or the last ``take``, read from ``engine.compile_cache_stats``.

A device counter (``count_device``) is an int64 table on the device that
each call adds a device tensor to, in place, at a row the caller names:
one add and no host sync a call.  ``device_counters`` brings the tables
to the host once, when the caller asks; ``take`` clears them.

Spans never synchronise the device: a span that should hold the device's
time ends at a host sync the program already makes (a ``.cpu()``), and
one that does not shows the time the host took to enqueue.  Spans touch
no tensor, so ``make_fx`` and fake tensors trace through them unchanged.
With ``annotate=True`` each span is also a
``torch.profiler.record_function`` range, so a ``torch.profiler`` run
that records CPU activity shows the spans on its own clock beside the
kernels they launched (and in its chrome trace).  Spans are recorded
from the thread that runs the program; the span names are listed in
``docs/torch_tracing.md``.
"""

from __future__ import annotations

import functools
import time
from contextlib import nullcontext

__all__ = ["span", "spanned", "count", "count_device", "recording",
           "device_counters", "enable", "disable", "take"]

#: what ``span`` returns while the recorder is off
NULL = nullcontext()


def _compile_misses() -> int:
    from repro_torch.core import engine
    return engine.compile_cache_stats()["misses"]


class _Record:
    def __init__(self):
        self.spans = []           # [name, t0_ns, t1_ns, parent, tags]
        self.stack = []           # indices of the open spans
        self.counters = {}
        self.device = {}          # name -> int64 table on the device
        self.misses = _compile_misses()


_rec = None          # the record being written; None while off
_kept = None         # the record kept after ``disable`` until ``take``
_annotate = False


class _Span:
    __slots__ = ("rec", "entry", "fn")

    def __init__(self, rec, name, tags):
        self.rec = rec
        self.entry = [name, 0, None, None, tags]
        self.fn = None

    def __enter__(self):
        rec, e = self.rec, self.entry
        e[3] = rec.stack[-1] if rec.stack else None
        rec.stack.append(len(rec.spans))
        rec.spans.append(e)
        e[1] = time.perf_counter_ns()
        if _annotate:
            import torch
            self.fn = torch.profiler.record_function(e[0])
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        self.entry[2] = time.perf_counter_ns()
        self.rec.stack.pop()
        return False


def span(name: str, **tags):
    """A context manager that records the time its body takes as span
    ``name`` with ``tags``; while the recorder is off, the shared
    ``NULL`` context."""
    rec = _rec
    if rec is None:
        return NULL
    return _Span(rec, name, tags)


def spanned(name: str):
    """Decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing while the recorder is off)."""
    rec = _rec
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def recording() -> bool:
    """Whether the recorder is on (a caller that would compute a
    counter's value only for the recorder asks first)."""
    return _rec is not None


def count_device(name: str, values, row: int = 0) -> None:
    """Add the device tensor ``values`` to row ``row`` of device counter
    ``name`` (an int64 table of ``values``' shape a row, grown as rows
    are named), in place and without a host sync; nothing while the
    recorder is off."""
    rec = _rec
    if rec is None:
        return
    t = rec.device.get(name)
    if t is None or t.shape[0] <= row:
        import torch
        grown = torch.zeros((row + 1,) + tuple(values.shape),
                            dtype=torch.int64, device=values.device)
        if t is not None:
            grown[:t.shape[0]] = t
        rec.device[name] = t = grown
    t[row].add_(values)


def device_counters() -> dict:
    """The device counters recorded so far, each brought to the host (one
    sync), by name; ``take`` clears them."""
    rec = _rec if _rec is not None else _kept
    if rec is None:
        return {}
    return {n: t.cpu() for n, t in rec.device.items()}


def enable(annotate: bool = False) -> None:
    """Start recording (or go on with the record kept by ``disable``)."""
    global _rec, _kept, _annotate
    if _rec is None:
        _rec = _kept if _kept is not None else _Record()
        _kept = None
    _annotate = bool(annotate)


def disable() -> None:
    """Stop recording; the record is kept until ``take``."""
    global _rec, _kept, _annotate
    if _rec is not None:
        _kept, _rec = _rec, None
    _annotate = False


def take():
    """``(spans, counters)`` recorded so far, and a fresh record (the
    device counters cleared).  A span still open has ``t1_ns`` None."""
    global _rec, _kept
    rec = _rec if _rec is not None else _kept
    if rec is None:
        return [], {}
    counters = dict(rec.counters)
    counters["engine.compile_misses"] = _compile_misses() - rec.misses
    spans = [tuple(e) for e in rec.spans]
    if _rec is not None:
        _rec = _Record()
    else:
        _kept = None
    return spans, counters
